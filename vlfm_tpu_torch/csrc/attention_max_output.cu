// The attention kernel's bf16 bodies with the row max subtracted and the output divided by the row sum
// (attention.cuh; attention.cu has the design note).
#include "attention.cuh"

template cudaError_t attn::launch_variant<true, false>(int, bool, const attn::Params&, dim3, size_t,
                                                        cudaStream_t);
