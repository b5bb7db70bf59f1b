// Point and ring kernels over Fq2 = Fq[u]/(u^2 + 1), 8 limbs: BN254 G2.

#include "kernels.cuh"

namespace zk {
const RingOps OPS_G2_8_1 = ops_of<RingFq2<8, 1>>();
}  // namespace zk
