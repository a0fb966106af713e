from repro_torch.kernels.chunk_attn.ops import chunk_attn, covers, takes
from repro_torch.kernels.chunk_attn.ref import chunk_attn_ref
