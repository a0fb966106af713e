from repro_torch.kernels.paged_attn.ops import paged_attention, paged_attn_cuda
from repro_torch.kernels.paged_attn.ref import paged_attn_ref
