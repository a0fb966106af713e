# Hand-written Hopper kernels of the port, one for each Pallas TPU kernel of
# the JAX package, each beside its plain PyTorch version (CPU tensors):
#   sc_mac     — fused B→S → AND → MUX-tree → popcount stochastic GEMM (§IV-B.1)
#   int8_mm    — int8×int8→int32 GEMM + dequant epilogue
#   act_pool   — fused 8-bit ReLU/tanh + p×p max/avg pool (§IV-B.2 add-on blocks)
#   paged_attn — decode attention over the paged device KV block pool
# and one that replaces a jnp core of the JAX package:
#   chunk_attn — chunked-prefill / mixed-tile attention over the same pool
#                (imported from its package, whose name it would shadow here)
from repro_torch.kernels.sc_mac import sc_matmul_fused
from repro_torch.kernels.int8_mm import int8_mm_fused, int8_matmul
from repro_torch.kernels.act_pool import act_pool
from repro_torch.kernels.paged_attn import paged_attention
