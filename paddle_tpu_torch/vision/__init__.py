"""paddle_tpu_torch.vision (counterpart of ``paddle_tpu/vision``):
``transforms``, ``datasets`` and the vision models the JAX package
re-exports here."""
from . import datasets, transforms
from ..models.resnet import ResNet, resnet18, resnet34, resnet50, resnet50_vd
from ..models.vit import ViTForImageClassification
