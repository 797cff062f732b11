// The baseline kernels B9 and B10 (csrc/baselines.cu) at head dim 32, built
// as a library of their own so that nvcc compiles each width in parallel.
#define CFA_HEAD_DIMS(X) X(32)
#include "baselines.cu"
