// K3's instantiations for the (32, 16) register tier on route 0 (the lanes' rows and fp64 factors in shared memory;
// riccati_chunk.cuh), in a translation unit of their own: the tier's are
// the longest to compile, so its routes build side by side.

#include "riccati_chunk.cuh"

MPC_K3_TIER_ROUTE(3, 32, 16, 0)
