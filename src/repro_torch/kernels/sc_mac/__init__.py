from repro_torch.kernels.sc_mac.ops import sc_mac_popcounts, sc_matmul_fused
from repro_torch.kernels.sc_mac.ref import leaf_masks, ranks_from_lut, sc_mac_plain, \
    sc_mac_split_ref, sc_matmul_hybrid_ref, sc_matmul_tree_ref, tile_k
from repro_torch.kernels.sc_mac.sc_mac import sc_mac_cuda, sc_plan
