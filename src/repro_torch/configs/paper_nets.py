"""The paper's own experiment networks (§VII Tables 1-4; port of
``repro.configs.paper_nets``, at the published widths).

A: MNIST MLP,  ReLU      (Table 1: FC 512-512-10, N/K = 5/5/5)
B: CIFAR CNN,  ReLU      (Table 2: conv 32,32,64,64 + FC 512-10)
C: MNIST MLP,  bsign+STE (Table 3: N/K = 5/2, 5, 4)
D: CIFAR CNN,  bsign+STE (Table 4)
"""

from ..nn.sequential import LayerSpec, SequentialConfig

NET_A = SequentialConfig(
    name="mnist-mlp-A",
    input_shape=(784,),
    layers=(
        LayerSpec("fc", out=512, activation="relu", n_over_k=5.0),
        LayerSpec("dropout", rate=0.2),
        LayerSpec("fc", out=512, activation="relu", n_over_k=5.0),
        LayerSpec("dropout", rate=0.2),
        LayerSpec("fc", out=10, activation="none", n_over_k=5.0),
    ),
)

NET_B = SequentialConfig(
    name="cifar-cnn-B",
    input_shape=(32, 32, 3),
    layers=(
        LayerSpec("conv", out=32, kernel=3, activation="relu", n_over_k=1.0 / 3.0),
        LayerSpec("conv", out=32, kernel=3, activation="relu", n_over_k=1.0),
        LayerSpec("maxpool", pool=2),
        LayerSpec("dropout", rate=0.25),
        LayerSpec("conv", out=64, kernel=3, activation="relu", n_over_k=1.0),
        LayerSpec("conv", out=64, kernel=3, activation="relu", n_over_k=1.0),
        LayerSpec("maxpool", pool=2),
        LayerSpec("dropout", rate=0.25),
        LayerSpec("flatten"),
        LayerSpec("fc", out=512, activation="relu", n_over_k=4.0),
        LayerSpec("dropout", rate=0.5),
        LayerSpec("fc", out=10, activation="none", n_over_k=1.0),
    ),
)

NET_C = SequentialConfig(
    name="mnist-mlp-C",
    input_shape=(784,),
    layers=(
        LayerSpec("fc", out=512, activation="bsign", n_over_k=2.5),
        LayerSpec("fc", out=512, activation="bsign", n_over_k=5.0),
        LayerSpec("fc", out=10, activation="none", n_over_k=4.0),
    ),
)

NET_D = SequentialConfig(
    name="cifar-cnn-D",
    input_shape=(32, 32, 3),
    layers=(
        LayerSpec("conv", out=32, kernel=3, activation="bsign", n_over_k=0.4),
        LayerSpec("conv", out=32, kernel=3, activation="bsign", n_over_k=1.0),
        LayerSpec("maxpool", pool=2),
        LayerSpec("conv", out=64, kernel=3, activation="bsign", n_over_k=1.5),
        LayerSpec("conv", out=64, kernel=3, activation="bsign", n_over_k=2.0),
        LayerSpec("maxpool", pool=2),
        LayerSpec("flatten"),
        LayerSpec("fc", out=512, activation="bsign", n_over_k=5.0),
        LayerSpec("fc", out=10, activation="none", n_over_k=1.0),
    ),
)

PAPER_NETS = {"A": NET_A, "B": NET_B, "C": NET_C, "D": NET_D}
