"""VGG-16 / CIFAR-10 — the paper's own Table 1 / Fig. 3(a) model."""
from repro_torch.nn.convnets import VGG16_PLAN, CNNConfig

CONFIG = CNNConfig(name="vgg16-cifar10", in_ch=3, n_classes=10,
                   plan=tuple(VGG16_PLAN))

# reduced variant used by CPU protocol experiments / tests
SMOKE = CNNConfig(name="vgg-smoke", width_mult=0.25,
                  plan=(16, 16, "M", 32, "M"), n_classes=4)
