from .resnet import ResNet, num_params  # noqa: F401
