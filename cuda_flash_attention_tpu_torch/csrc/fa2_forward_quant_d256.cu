// The quantized-KV FA2 forward B7 (csrc/fa2_forward_quant.cu) at head dim
// 256, built as a library of its own so that nvcc compiles each width in
// parallel.
#define CFA_HEAD_DIMS(X) X(256)
#include "fa2_forward_quant.cu"
