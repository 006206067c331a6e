"""LeNet-5 (MNIST, Table I row 1) as an im2col-GEMM CNN with DBB
weights."""
from repro_torch.config import DbbConfig, ModelConfig

ARCH = "lenet5-dbb"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="cnn",
        cnn_channels=(6, 16), cnn_kernel=5, cnn_classes=10,
        cnn_img=28, cnn_in_ch=1, dtype="float32", param_dtype="float32",
        dbb=DbbConfig(enabled=True, block=8, nnz=2,   # Table I: 25% NNZ
                      apply_to=("conv",)),
    )


def smoke() -> ModelConfig:
    return full().replace(cnn_channels=(4, 8), cnn_img=16)
