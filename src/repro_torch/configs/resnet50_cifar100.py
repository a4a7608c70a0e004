"""ResNet / CIFAR-100, the paper's Table 2 / Fig. 3(b) model: the
basic-block variant for runnable experiments (the analytic accounting,
`core.accounting`, uses the true ResNet-50 costs)."""
from repro_torch.nn.convnets import ResNetConfig

CONFIG = ResNetConfig(name="resnet-cifar100", stages=(3, 4, 6, 3),
                      widths=(64, 128, 256, 512), n_classes=100)

SMOKE = ResNetConfig(name="resnet-smoke", stages=(1, 1), widths=(16, 32),
                     n_classes=4, width_mult=0.5)
