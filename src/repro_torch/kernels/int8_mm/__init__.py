from repro_torch.kernels.int8_mm.int8_mm import int8_mm_cuda
from repro_torch.kernels.int8_mm.ops import int8_matmul, int8_mm_fused
from repro_torch.kernels.int8_mm.ref import int8_mm_ref
