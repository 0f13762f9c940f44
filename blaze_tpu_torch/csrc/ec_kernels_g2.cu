// K2-K6 on BN254's G2 (F_p2 coordinates, 16 words: Fp2 over the 8-word
// field): the instances of ec_kernels.cuh, a library apart from G1's.
#define BLZ_EC_INSTANCES(call)                         \
  case 16: { using F = Fp2<8>; return call; }

#include "ec_kernels.cuh"
