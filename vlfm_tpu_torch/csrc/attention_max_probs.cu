// The attention kernel's bf16 bodies with the row max subtracted and p normalised before PV
// (attention.cuh; attention.cu has the design note).
#include "attention.cuh"

template cudaError_t attn::launch_variant<true, true>(int, bool, const attn::Params&, dim3, size_t,
                                                        cudaStream_t);
