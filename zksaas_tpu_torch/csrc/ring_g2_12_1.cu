// Point and ring kernels over Fq2 = Fq[u]/(u^2 + 1), 12 limbs: BLS12-381 G2.

#include "kernels.cuh"

namespace zk {
const RingOps OPS_G2_12_1 = ops_of<RingFq2<12, 1>>();
}  // namespace zk
