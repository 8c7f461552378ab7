"""The paper's three benchmark CNNs (Table 2): LeNet-5 (MNIST),
Alex Krizhevsky's CIFAR-10 network, and AlexNet (ImageNet 2012).

A copy of ``repro.core.netdefs``: the two packages describe the same
networks with the same layer names, so one artifact and one set of
weights serve both."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    kind: str  # conv | pool | lrn | fc | relu | softmax | flatten
    name: str
    # conv/fc
    out_channels: int = 0
    kernel: Tuple[int, int] = (0, 0)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    relu: bool = False  # fused activation (paper §4.2)
    # pool
    pool_kind: str = "max"  # max | avg
    # lrn
    lrn_n: int = 5
    lrn_alpha: float = 1e-4
    lrn_beta: float = 0.75
    lrn_k: float = 1.0


@dataclass(frozen=True)
class NetworkDef:
    name: str
    input_shape: Tuple[int, int, int]  # (C, H, W)
    num_classes: int
    layers: Tuple[LayerSpec, ...]


def lenet5() -> NetworkDef:
    """LeNet-5 for MNIST [13] — Table 2 column 1."""
    return NetworkDef(
        name="lenet5",
        input_shape=(1, 28, 28),
        num_classes=10,
        layers=(
            LayerSpec("conv", "conv1", out_channels=20, kernel=(5, 5)),
            LayerSpec("pool", "pool1", kernel=(2, 2), stride=(2, 2)),
            LayerSpec("conv", "conv2", out_channels=50, kernel=(5, 5)),
            LayerSpec("pool", "pool2", kernel=(2, 2), stride=(2, 2)),
            LayerSpec("flatten", "flatten"),
            LayerSpec("fc", "fc1", out_channels=500, relu=True),
            LayerSpec("fc", "fc2", out_channels=10),
            LayerSpec("softmax", "prob"),
        ),
    )


def cifar10_quick() -> NetworkDef:
    """Krizhevsky's CIFAR-10 network [14] — Table 2 column 2."""
    return NetworkDef(
        name="cifar10",
        input_shape=(3, 32, 32),
        num_classes=10,
        layers=(
            LayerSpec("conv", "conv1", out_channels=32, kernel=(5, 5),
                      padding=(2, 2)),
            LayerSpec("pool", "pool1", kernel=(3, 3), stride=(2, 2),
                      relu=True),
            LayerSpec("conv", "conv2", out_channels=32, kernel=(5, 5),
                      padding=(2, 2), relu=True),
            LayerSpec("pool", "pool2", kernel=(3, 3), stride=(2, 2),
                      pool_kind="avg"),
            LayerSpec("conv", "conv3", out_channels=64, kernel=(5, 5),
                      padding=(2, 2), relu=True),
            LayerSpec("pool", "pool3", kernel=(3, 3), stride=(2, 2),
                      pool_kind="avg"),
            LayerSpec("flatten", "flatten"),
            LayerSpec("fc", "fc1", out_channels=64),
            LayerSpec("fc", "fc2", out_channels=10),
            LayerSpec("softmax", "prob"),
        ),
    )


def alexnet() -> NetworkDef:
    """Alex Krizhevsky's ImageNet 2012 CNN [15] (single-tower shapes,
    Fig. 8) — Table 2 column 3."""
    return NetworkDef(
        name="alexnet",
        input_shape=(3, 227, 227),
        num_classes=1000,
        layers=(
            LayerSpec("conv", "conv1", out_channels=96, kernel=(11, 11),
                      stride=(4, 4), relu=True),
            LayerSpec("pool", "pool1", kernel=(3, 3), stride=(2, 2)),
            LayerSpec("lrn", "norm1"),
            LayerSpec("conv", "conv2", out_channels=256, kernel=(5, 5),
                      padding=(2, 2), relu=True),
            LayerSpec("pool", "pool2", kernel=(3, 3), stride=(2, 2)),
            LayerSpec("lrn", "norm2"),
            LayerSpec("conv", "conv3", out_channels=384, kernel=(3, 3),
                      padding=(1, 1), relu=True),
            LayerSpec("conv", "conv4", out_channels=384, kernel=(3, 3),
                      padding=(1, 1), relu=True),
            LayerSpec("conv", "conv5", out_channels=256, kernel=(3, 3),
                      padding=(1, 1), relu=True),
            LayerSpec("pool", "pool5", kernel=(3, 3), stride=(2, 2)),
            LayerSpec("flatten", "flatten"),
            LayerSpec("fc", "fc6", out_channels=4096, relu=True),
            LayerSpec("fc", "fc7", out_channels=4096, relu=True),
            LayerSpec("fc", "fc8", out_channels=1000),
            LayerSpec("softmax", "prob"),
        ),
    )


NETWORKS = {"lenet5": lenet5, "cifar10": cifar10_quick, "alexnet": alexnet}
