// The attention kernel's bf16 bodies with clamped logits and p normalised before PV
// (attention.cuh; attention.cu has the design note).
#include "attention.cuh"

template cudaError_t attn::launch_variant<false, true>(int, bool, const attn::Params&, dim3, size_t,
                                                        cudaStream_t);
