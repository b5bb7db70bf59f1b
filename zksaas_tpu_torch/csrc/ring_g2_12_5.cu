// Point and ring kernels over Fq2 = Fq[u]/(u^2 + 5), 12 limbs: BLS12-377 G2.

#include "kernels.cuh"

namespace zk {
const RingOps OPS_G2_12_5 = ops_of<RingFq2<12, 5>>();
}  // namespace zk
