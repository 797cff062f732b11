// The baseline kernels B9 and B10 (csrc/baselines.cu) on fp16 inputs, at
// every head dim, built as a library of its own so that nvcc compiles these
// instantiations in parallel with the fp32 and bf16 ones.
#define CFA_FP16_INPUTS
#define CFA_HEAD_DIMS(X) X(32) X(64) X(128) X(256)
#include "baselines.cu"
