"""Load the JAX package's model parameters into the port's modules.

`resnet_from_jax(variables)` takes what `horovod_tpu.models.resnet_init`
returns — {"params", "batch_stats", "config"}, leaves as numpy arrays
(or anything `np.asarray` takes) — and returns a `ResNet` holding the
same weights: conv HWIO → OIHW, dense (in, out) → (out, in), batch-norm
scale/bias → weight/bias and mean/var → running_mean/running_var.

`inception_from_jax(variables)`, `vgg_from_jax(variables)` and
`mnist_from_jax(params)` do the same for the rest of the zoo, and
`zoo_from_jax(name, variables)` picks by zoo name.  VGG-16's and the
MNIST net's fc1 read the JAX flatten of an NHWC map, (h, w, c); the
port flattens NCHW, (c, h, w), so their fc1 input rows are permuted.

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
from .inception import ConvBN, Inception3
from .mnist import MnistNet
from .resnet import ResNet
from .transformer import Transformer, TransformerConfig
from .vgg import VGG16


def _tensor(a, transpose=None) -> torch.Tensor:
    a = np.array(a, dtype=np.float32)
    if transpose is not None:
        a = np.ascontiguousarray(np.transpose(a, transpose))
    return torch.from_numpy(a)


def resnet_from_jax(variables: Dict[str, Any],
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                    sync_bn=None) -> ResNet:
    params = variables["params"]
    stats = variables["batch_stats"]
    depth = int(variables["config"]["depth"])
    num_classes = int(np.shape(params["head"]["kernel"])[1])
    model = ResNet(depth, num_classes, compute_dtype=compute_dtype,
                   sync_bn=sync_bn)
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


def _conv(mod: L.Conv2d, p) -> None:
    mod.weight.copy_(_tensor(p["kernel"], (3, 2, 0, 1)))
    if mod.bias is not None:
        mod.bias.copy_(_tensor(p["bias"]))


def _dense(mod: L.Dense, p, nhwc=None) -> None:
    """`nhwc`: (h, w, c) of the NHWC map the JAX kernel's input rows
    flatten, to be reordered to the port's (c, h, w) flatten."""
    k = np.asarray(p["kernel"], dtype=np.float32)
    if nhwc is not None:
        h, w, c = nhwc
        k = k.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(h * w * c,
                                                                  -1)
    mod.weight.copy_(_tensor(k, (1, 0)))
    mod.bias.copy_(_tensor(p["bias"]))


def inception_from_jax(variables: Dict[str, Any],
                       compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                       sync_bn=None) -> Inception3:
    """`inception3_init`'s {"params", "batch_stats"}: the unit at the
    port's path "mixed0.b1x1" is the JAX entry "mixed0/b1x1"."""
    params, stats = variables["params"], variables["batch_stats"]
    num_classes = int(np.shape(params["head"]["kernel"])[1])
    model = Inception3(num_classes, compute_dtype=compute_dtype,
                       sync_bn=sync_bn)
    with torch.no_grad():
        for path, mod in model.named_modules():
            if path == "head":
                _dense(mod, params["head"])
            elif isinstance(mod, ConvBN):
                key = path.replace(".", "/")
                p, s = params[key], stats[key]
                _conv(mod.conv, p["conv"])
                mod.bn.weight.copy_(_tensor(p["bn"]["scale"]))
                mod.bn.bias.copy_(_tensor(p["bn"]["bias"]))
                mod.bn.running_mean.copy_(_tensor(s["mean"]))
                mod.bn.running_var.copy_(_tensor(s["var"]))
    return model


def vgg_from_jax(variables: Dict[str, Any],
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16
                 ) -> VGG16:
    """`vgg16_init`'s {"params", "config": {"image_size"}}."""
    params = variables["params"]
    image_size = int(variables["config"]["image_size"])
    num_classes = int(np.shape(params["head"]["kernel"])[1])
    model = VGG16(num_classes, image_size, compute_dtype=compute_dtype)
    side = image_size // 32
    with torch.no_grad():
        for name, mod in model.named_children():
            if isinstance(mod, L.Conv2d):
                _conv(mod, params[name])
        _dense(model.fc1, params["fc1"],
               nhwc=(side, side, model.fc1.weight.shape[1] // side ** 2))
        _dense(model.fc2, params["fc2"])
        _dense(model.head, params["head"])
    return model


def mnist_from_jax(params: Dict[str, Any]) -> MnistNet:
    """`mnist_cnn_init`'s parameter tree: conv1, conv2, fc1, fc2."""
    model = MnistNet()
    with torch.no_grad():
        _conv(model.conv1, params["conv1"])
        _conv(model.conv2, params["conv2"])
        _dense(model.fc1, params["fc1"], nhwc=(4, 4, 20))
        _dense(model.fc2, params["fc2"])
    return model


def zoo_from_jax(name: str, variables: Dict[str, Any],
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
    """The port's zoo model `name` holding the weights of the JAX
    package's `zoo_init(name, ...)` variables."""
    if name == "inception3":
        return inception_from_jax(variables, compute_dtype)
    if name == "vgg16":
        return vgg_from_jax(variables, compute_dtype)
    if name.startswith("resnet"):
        return resnet_from_jax(variables, compute_dtype)
    raise ValueError(f"unknown model {name!r}")


def transformer_from_jax(params: Dict[str, Any],
                         cfg: TransformerConfig) -> Transformer:
    """params: {"embed", "final_norm": {"scale"}, "blocks": {"ln1":
    {"scale"}, "ln2": {"scale"}, "wq", "wk", "wv", "wo", "wi", "wg",
    "wd"}} with a leading [n_layers] axis on every block leaf, and with
    MoE layers "moe": {"gate": {"kernel"} [n_moe, D, E], "wi" [n_moe, E,
    D, F], "wo" [n_moe, E, F, D]} (numpy or torch arrays)."""
    model = Transformer(cfg)
    blocks = params["blocks"]
    moes = [b.moe for b in model.blocks if b.moe is not None]
    if bool(moes) != ("moe" in params):
        raise ValueError(f"{len(moes)} MoE layers in the config, "
                         f"{'some' if 'moe' in params else 'none'} in the "
                         "parameters")
    with torch.no_grad():
        model.embed.copy_(_tensor(params["embed"]))
        model.final_norm.copy_(_tensor(params["final_norm"]["scale"]))
        for i, block in enumerate(model.blocks):
            block.ln1.copy_(_tensor(np.asarray(blocks["ln1"]["scale"])[i]))
            block.ln2.copy_(_tensor(np.asarray(blocks["ln2"]["scale"])[i]))
            for name in ("wq", "wk", "wv", "wo", "wi", "wg", "wd"):
                getattr(block, name).copy_(
                    _tensor(np.asarray(blocks[name])[i]))
        for i, moe in enumerate(moes):
            moe.gate.copy_(_tensor(np.asarray(
                params["moe"]["gate"]["kernel"])[i]))
            moe.wi.copy_(_tensor(np.asarray(params["moe"]["wi"])[i]))
            moe.wo.copy_(_tensor(np.asarray(params["moe"]["wo"])[i]))
    return model


def shard_from_jax(params: Dict[str, Any], cfg: TransformerConfig,
                   mesh) -> Dict[str, Any]:
    """This rank's shards of the JAX parameters (the `transformer_init`
    tree, not yet stacked for the pipeline), as numpy f32 arrays: the
    tree stacked by `stack_for_pipeline` when pp > 1 and sliced by
    `transformer_pspecs` at the rank's mesh coordinate, the
    counterpart of the JAX `shard_state`'s placement."""
    from .transformer import shard_params, tree_map

    return tree_map(lambda a: np.ascontiguousarray(a),
                    shard_params(tree_map(lambda a: np.asarray(
                        a, np.float32), params), cfg, mesh))


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
