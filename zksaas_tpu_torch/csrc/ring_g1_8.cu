// Point and ring kernels over the 8-limb Fq: BN254 G1.

#include "kernels.cuh"

namespace zk {
const RingOps OPS_G1_8 = ops_of<RingFq<8>>();
}  // namespace zk
