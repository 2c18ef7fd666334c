"""The paper's own model architectures (ASO-Fed §5.3).

* ``paper-lstm``: single-layer LSTM + one fully-connected head — used for the
  three real-world streaming datasets (FitRec, Air Quality, ExtraSensory).
* ``paper-cnn``: two conv layers + max-pool + FC — used for Fashion-MNIST.

These run in fp32 on CPU and are the substrate for the Table 5.1 / 6.1 /
Fig 3-6 reproduction benchmarks.
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("paper-lstm")
def paper_lstm() -> ModelConfig:
    return ModelConfig(
        name="paper-lstm",
        family="lstm",
        citation="ASO-Fed §5.3",
        in_features=16,  # overridden per dataset
        out_features=1,
        hidden=64,
    )


@ARCHS.register("paper-cnn")
def paper_cnn() -> ModelConfig:
    return ModelConfig(
        name="paper-cnn",
        family="cnn",
        citation="ASO-Fed §5.3",
        in_features=28 * 28,
        out_features=10,
        hidden=32,  # conv channels
    )
