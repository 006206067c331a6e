"""The paper's 5-layer ConvNet (CIFAR-10, Table I row 2): convs lowered to
GEMM via im2col, so DBB runs along the GEMM contraction dim."""
from repro_torch.config import DbbConfig, ModelConfig

ARCH = "convnet-dbb"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="cnn",
        cnn_channels=(64, 128, 256), cnn_kernel=3, cnn_classes=10,
        cnn_img=32, cnn_in_ch=3, dtype="float32", param_dtype="float32",
        dbb=DbbConfig(enabled=True, block=8, nnz=2,   # Table I: 25% NNZ
                      apply_to=("conv",)),
    )


def smoke() -> ModelConfig:
    return full().replace(cnn_channels=(16, 32), cnn_img=16)
