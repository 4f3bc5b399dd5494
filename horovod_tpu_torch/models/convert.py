"""Load the JAX package's model parameters into the port's modules.

`resnet_from_jax(variables)` takes what `horovod_tpu.models.resnet_init`
returns — {"params", "batch_stats", "config"}, leaves as numpy arrays
(or anything `np.asarray` takes) — and returns a `ResNet` holding the
same weights: conv HWIO → OIHW, dense (in, out) → (out, in), batch-norm
scale/bias → weight/bias and mean/var → running_mean/running_var.

`transformer_from_jax(params, cfg)` takes `transformer_init`'s
layer-stacked [L, ...] tree and returns a `Transformer` with the same
weights; the port keeps the JAX shapes, so each leaf is copied as it is.

`zero_rows_from_jax(placement, rows)` takes the rows of the JAX
package's ZeRO-3 placement (one (n, shard) array per shard group, as
numpy) and returns this rank's rows of the port's `placement` over the
same leaves, so that both hold the same shards (re-cut when the two
world sizes differ).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import layers as L
from .resnet import ResNet
from .transformer import Transformer, TransformerConfig


def _tensor(a, transpose=None) -> torch.Tensor:
    a = np.array(a, dtype=np.float32)
    if transpose is not None:
        a = np.ascontiguousarray(np.transpose(a, transpose))
    return torch.from_numpy(a)


def resnet_from_jax(variables: Dict[str, Any],
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16
                    ) -> ResNet:
    params = variables["params"]
    stats = variables["batch_stats"]
    depth = int(variables["config"]["depth"])
    num_classes = int(np.shape(params["head"]["kernel"])[1])
    model = ResNet(depth, num_classes, compute_dtype=compute_dtype)
    with torch.no_grad():
        for path, mod in model.named_modules():
            if not path:
                continue
            keys = path.split(".")
            p = params
            for k in keys:
                p = p[k]
            if isinstance(mod, L.Conv2d):
                mod.weight.copy_(_tensor(p["kernel"], (3, 2, 0, 1)))
            elif isinstance(mod, L.Dense):
                mod.weight.copy_(_tensor(p["kernel"], (1, 0)))
                mod.bias.copy_(_tensor(p["bias"]))
            elif isinstance(mod, L.BatchNorm):
                s = stats
                for k in keys:
                    s = s[k]
                mod.weight.copy_(_tensor(p["scale"]))
                mod.bias.copy_(_tensor(p["bias"]))
                mod.running_mean.copy_(_tensor(s["mean"]))
                mod.running_var.copy_(_tensor(s["var"]))
    return model


def transformer_from_jax(params: Dict[str, Any],
                         cfg: TransformerConfig) -> Transformer:
    """params: {"embed", "final_norm": {"scale"}, "blocks": {"ln1":
    {"scale"}, "ln2": {"scale"}, "wq", "wk", "wv", "wo", "wi", "wg",
    "wd"}} with a leading [n_layers] axis on every block leaf."""
    if "moe" in params:
        raise NotImplementedError("MoE parameters are not ported yet")
    model = Transformer(cfg)
    blocks = params["blocks"]
    with torch.no_grad():
        model.embed.copy_(_tensor(params["embed"]))
        model.final_norm.copy_(_tensor(params["final_norm"]["scale"]))
        for i, block in enumerate(model.blocks):
            block.ln1.copy_(_tensor(np.asarray(blocks["ln1"]["scale"])[i]))
            block.ln2.copy_(_tensor(np.asarray(blocks["ln2"]["scale"])[i]))
            for name in ("wq", "wk", "wv", "wo", "wi", "wg", "wd"):
                getattr(block, name).copy_(
                    _tensor(np.asarray(blocks[name])[i]))
    return model


def zero_rows_from_jax(placement, rows) -> tuple:
    """The JAX `ZeroParamPlacement.shard` rows (numpy (n, shard) arrays,
    one per group, the same partition) as the port placement's (1, shard)
    rows of this rank: each group's buffer unpadded, padded again for the
    port's world size, and this rank's band taken."""
    if len(rows) != len(placement.groups):
        raise ValueError(f"{len(rows)} JAX rows for "
                         f"{len(placement.groups)} shard groups")
    out = []
    for g, row in zip(placement.groups, rows):
        flat = np.asarray(row).reshape(-1)[:sum(g.sizes)]
        flat = np.concatenate([flat, np.zeros(g.padded - flat.size,
                                              flat.dtype)])
        lo = placement.rank * g.shard_sz
        out.append(torch.from_numpy(
            flat[lo:lo + g.shard_sz].reshape(1, -1).copy()).to(g.dtype))
    return tuple(out)
