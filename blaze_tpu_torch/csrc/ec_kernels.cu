// K2-K6 on G1 (F_p coordinates, W = 8 and 12 words): the instances of
// ec_kernels.cuh, which holds the kernels, their design and bounds.
// BN254's G2 instances are ec_kernels_g2.cu's.
#define BLZ_EC_INSTANCES(call)                         \
  case 8: { using F = Fp<8>; return call; }            \
  case 12: { using F = Fp<12>; return call; }

#include "ec_kernels.cuh"
