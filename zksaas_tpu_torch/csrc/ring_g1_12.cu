// Point and ring kernels over the 12-limb Fq: BLS12-381 and BLS12-377 G1.

#include "kernels.cuh"

namespace zk {
const RingOps OPS_G1_12 = ops_of<RingFq<12>>();
}  // namespace zk
