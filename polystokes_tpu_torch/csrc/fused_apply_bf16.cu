// The bf16-storage forms (coeff_bf16) of the plane-window kernels and the
// finish kernel of fused_apply.cu: the same source with only the bf16 entry
// points instantiated, ps_<name>[_k<K>]_<f32|f64>_bf16.  A translation unit
// of its own because packed_apply.py build_kernels starts one nvcc per .cu
// file, all together: split, the two halves of the plane window's
// instantiations build in parallel.
#define PS_FUSED_APPLY_BF16
#include "fused_apply.cu"
