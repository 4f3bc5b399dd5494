from .resnet import ResNet, num_params  # noqa: F401
from .transformer import Transformer, TransformerConfig, lm_loss  # noqa: F401
from .convert import resnet_from_jax, transformer_from_jax  # noqa: F401
