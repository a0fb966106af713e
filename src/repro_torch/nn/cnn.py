"""CNN models for the paper's benchmark topologies (Table 4), in PyTorch.

The runnable counterparts of the ``pim.trace`` topologies: the same layer
stacks, executable forward and training, with the ODIN execution modes
(exact | int8 | sc) applied to every MAC layer.  Convolution lowers to
im2col + ``odin_linear`` (the way ODIN maps conv MACs onto row ops),
pooling and ReLU stay in the binary domain.  Layout and ops are the JAX
package's ``nn/cnn.py`` (NHWC, patch order (i, j, c)).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.odin_linear import OdinConfig, odin_linear
from repro_torch.nn.module import ParamSpec
from repro_torch.pim.trace import FC, Conv, Pool, Topology

__all__ = ["cnn_param_spec", "cnn_forward", "cnn_loss", "topology_input_hw",
           "mac_layers", "RUNNABLE_CNN1", "RUNNABLE_CNN2"]

# The paper's Table 4 strings are dimensionally inconsistent as printed; the
# runnable models take the nearby reading that makes dimensions consistent
# (the JAX package's choice):
#   CNN1: 5×5 conv, 4 maps, SAME pad  → pool2 → 14·14·4 = 784 → 70 → 10
#   CNN2: 7×7 conv, 10 maps, VALID pad → pool2 → 11·11·10 = 1210 → 120 → 10
RUNNABLE_CNN1 = Topology(
    "CNN1-run",
    [Conv(28, 28, 1, 5, 4, 1, 2), Pool(28, 28, 4, 2), FC(784, 70), FC(70, 10)],
    "synthetic-digits",
)
RUNNABLE_CNN2 = Topology(
    "CNN2-run",
    [Conv(28, 28, 1, 7, 10, 1, 0), Pool(22, 22, 10, 2), FC(1210, 120), FC(120, 10)],
    "synthetic-digits",
)


def topology_input_hw(topo: Topology) -> Tuple[int, int, int]:
    first = topo.layers[0]
    if isinstance(first, Conv):
        return first.h, first.w, first.c_in
    return 1, 1, first.n_in                 # FC-first topology: flat input


def mac_layers(topo: Topology) -> int:
    """Layers that run a MAC array (conv and FC)."""
    return sum(isinstance(layer, (Conv, FC)) for layer in topo.layers)


def _im2col(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """NHWC → [B, OH, OW, k·k·C] patch matrix."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    OH = (H + 2 * pad - k) // stride + 1
    OW = (W + 2 * pad - k) // stride + 1
    patches = [
        xp[:, i:i + OH * stride:stride, j:j + OW * stride:stride, :]
        for i in range(k)
        for j in range(k)
    ]
    return torch.cat(patches, dim=-1).reshape(B, OH, OW, k * k * C)


def cnn_param_spec(topo: Topology) -> Dict[str, ParamSpec]:
    """ParamSpec tree mirroring the topology's MAC layers."""
    spec: Dict[str, ParamSpec] = {}
    for idx, layer in enumerate(topo.layers):
        if isinstance(layer, Conv):
            spec[f"conv{idx}"] = ParamSpec((layer.k * layer.k * layer.c_in, layer.c_out),
                                           ("embed", "mlp"), torch.float32, init="fan_in")
        elif isinstance(layer, FC):
            spec[f"fc{idx}"] = ParamSpec((layer.n_in, layer.n_out), ("embed", "mlp"),
                                         torch.float32, init="fan_in")
    return spec


def _relu_pool_binary(y: torch.Tensor, pool: int) -> torch.Tensor:
    """The paper's binary-domain ReLU + max-pool."""
    r = F.relu(y)
    B, H, W, C = r.shape
    return r.reshape(B, H // pool, pool, W // pool, pool, C).amax(dim=(2, 4))


def cnn_forward(params: Dict, x: torch.Tensor, topo: Topology,
                odin: Optional[OdinConfig] = None, luts=None) -> torch.Tensor:
    """x: [B, H, W, C] (or [B, n_in] for FC-first) → logits [B, n_classes].

    Conv/FC MACs run under the configured ODIN mode, ReLU between layers,
    Pool as binary max.  ``luts`` overrides the sc mode's tables.
    """
    h = x
    flat = False
    for idx, layer in enumerate(topo.layers):
        if isinstance(layer, Conv):
            patches = _im2col(h, layer.k, layer.stride, layer.pad)
            B, OH, OW, P = patches.shape
            y = _linear(patches.reshape(-1, P), params[f"conv{idx}"], odin, luts)
            h = F.relu(y.reshape(B, OH, OW, layer.c_out))
        elif isinstance(layer, Pool):
            h = _relu_pool_binary(h, layer.size)
        elif isinstance(layer, FC):
            if not flat:
                h = h.reshape(h.shape[0], -1)
                flat = True
            y = _linear(h, params[f"fc{idx}"], odin, luts)
            h = y if idx == len(topo.layers) - 1 else F.relu(y)
    return h


def _linear(x: torch.Tensor, w: torch.Tensor, odin: Optional[OdinConfig], luts) -> torch.Tensor:
    if odin is None or odin.mode == "exact":
        return x @ w
    return odin_linear(x, w, odin, luts=luts)


def cnn_loss(params: Dict, batch: Dict, topo: Topology) -> Tuple[torch.Tensor, Dict]:
    logits = cnn_forward(params, batch["image"], topo, odin=None)
    lp = F.log_softmax(logits, dim=-1)
    loss = -lp.gather(-1, batch["label"].long()[:, None]).mean()
    acc = (logits.argmax(-1) == batch["label"]).float().mean()
    return loss, {"loss": loss.detach(), "acc": acc}
