from repro_torch.core.stochastic import (
    StreamSpec,
    make_lut,
    make_select_streams,
    b_to_s,
    s_to_b,
    sc_mul,
    sc_mux,
    sc_mac_tree,
    sc_matmul,
    expected_matmul,
    pack_bits,
    unpack_bits,
    tree_depth,
)
from repro_torch.core.quant import QuantParams, quantize_unipolar, quantize_signed_tworail, dequantize
from repro_torch.core.odin_linear import OdinConfig, odin_linear, get_luts
