"""The model zoo (counterpart of `horovod_tpu/models/__init__.py`).

`zoo_build(name, ...)` builds a benchmark model by its tf_cnn_benchmarks
name ("resnet50", "inception3", "vgg16", ...: `zoo_models()`).  The
decode names (prefill, decode step, extend, generate, speculative, beam
search, `make_decode_step`) are `models/decode.py`'s.
"""

from typing import Optional

import torch

from .resnet import STAGE_SIZES, ResNet, num_params  # noqa: F401
from .inception import Inception3  # noqa: F401
from .vgg import VGG16  # noqa: F401
from .mnist import MnistNet, nll_loss  # noqa: F401
from .transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    lm_loss,
    make_train_step,
    stack_for_pipeline,
    transformer_init,
    transformer_params,
    transformer_pspecs,
)
from .convert import (  # noqa: F401
    inception_from_jax,
    mnist_from_jax,
    resnet_from_jax,
    shard_from_jax,
    transformer_from_jax,
    vgg_from_jax,
    zoo_from_jax,
)
from .decode import (  # noqa: F401
    ShardedDecode,
    init_decode_cache,
    make_decode_step,
    transformer_beam_search,
    transformer_decode_step,
    transformer_extend,
    transformer_generate,
    transformer_prefill,
    transformer_speculative_generate,
)


def zoo_models():
    """Benchmarkable model names (tf_cnn_benchmarks naming), sorted."""
    return sorted([f"resnet{d}" for d in STAGE_SIZES]
                  + ["inception3", "vgg16"])


def zoo_build(name: str, num_classes: int = 1000,
              compute_dtype: Optional[torch.dtype] = torch.bfloat16,
              seed: int = 0, image_size: int = 224) -> torch.nn.Module:
    """The zoo model `name`.  `image_size` sizes VGG-16's fc1; the other
    models take any size."""
    if name not in zoo_models():
        raise ValueError(f"unknown model {name!r}; have {zoo_models()}")
    if name == "vgg16":
        return VGG16(num_classes, image_size, compute_dtype, seed)
    if name == "inception3":
        return Inception3(num_classes, compute_dtype, seed)
    return ResNet(int(name[len("resnet"):]), num_classes, compute_dtype,
                  seed)
