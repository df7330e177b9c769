// K3's instantiations for the (8, 4) register tier (riccati_chunk.cuh), in a
// translation unit of their own so that the tiers build side by side.

#include "riccati_chunk.cuh"

MPC_K3_TIER_ROUTE(1, 8, 4, 0)
MPC_K3_TIER_ROUTE(1, 8, 4, 1)
MPC_K3_TIER_ROUTE(1, 8, 4, 2)
