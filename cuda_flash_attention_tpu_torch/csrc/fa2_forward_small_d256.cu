// The small-problem FA2 forward B8 (csrc/fa2_forward_small.cu) at head dim
// 256, built as a library of its own so that nvcc compiles each width in
// parallel.
#define CFA_HEAD_DIMS(X) X(256)
#include "fa2_forward_small.cu"
