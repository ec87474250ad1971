// The attention kernel's bf16 bodies with clamped logits and the output divided by the row sum
// (attention.cuh; attention.cu has the design note).
#include "attention.cuh"

template cudaError_t attn::launch_variant<false, false>(int, bool, const attn::Params&, dim3, size_t,
                                                        cudaStream_t);
