"""Configuration and vocabulary layout of the port.

The port's own copy of what it uses from musicgen_tpu/config.py (reference
configs/common/__init__.py, configs/common/config.yaml): the same frozen
dataclasses with the same field names and defaults, standard library only.
The port imports nothing of the JAX package.

    vocab_size = pitch*channel + dyn + length + time + tempo = 17,914
    start_idx  = {pitch: 0, dyn: 16512, length: 16640, time: 17152, tempo: 17664}
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class Discretization:
    """Event-field bin counts (reference configs/common/config.yaml:1-7)."""

    pitch: int = 128
    dyn: int = 128
    length: int = 512
    time: int = 512
    channel: int = 129  # 128 instruments + 1 drum channel
    tempo: int = 250


@dataclasses.dataclass(frozen=True)
class VocabLayout:
    """Derived token-id layout over the 17,914-entry event vocabulary."""

    disc: Discretization = Discretization()

    @property
    def pitch_start(self) -> int:
        return 0

    @property
    def dyn_start(self) -> int:
        return self.disc.pitch * self.disc.channel

    @property
    def length_start(self) -> int:
        return self.dyn_start + self.disc.dyn

    @property
    def time_start(self) -> int:
        return self.length_start + self.disc.length

    @property
    def tempo_start(self) -> int:
        return self.time_start + self.disc.time

    @property
    def vocab_size(self) -> int:
        return self.tempo_start + self.disc.tempo

    @property
    def start_idx(self) -> Mapping[str, int]:
        return {
            "pitch": self.pitch_start,
            "dyn": self.dyn_start,
            "length": self.length_start,
            "time": self.time_start,
            "tempo": self.tempo_start,
        }

    @property
    def field_boundaries(self) -> Tuple[int, int, int, int]:
        """Bucketize boundaries of the grammar filter (reference
        train.py:117-121): [dyn-1, length-1, time-1, tempo-1]."""
        return (
            self.dyn_start - 1,
            self.length_start - 1,
            self.time_start - 1,
            self.tempo_start - 1,
        )

    def padded_vocab_size(self, multiple: int = 128) -> int:
        """The vocab rounded up for kernel tiling (17914 -> 17920)."""
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple


VOCAB = VocabLayout()
VOCAB_SIZE = VOCAB.vocab_size  # 17914

# Metadata vocabulary (composer/band + genres + decade tokens).
DEFAULT_METADATA_VOCAB_SIZE = 568
NUM_META_TOKENS = 6  # [band, genre x4 (padded), decade]
NUM_META = NUM_META_TOKENS


@dataclasses.dataclass(frozen=True)
class Resolution:
    """Beat-grid quantization (reference configs/common/config.yaml:9-10)."""

    bar_res: int = 64  # ticks per beat


@dataclasses.dataclass(frozen=True)
class TrainValues:
    """Training hyperparameters (reference configs/common/config.yaml:12-27)."""

    block_len: int = 2048
    dropout: float = 0.01
    epochs: int = 10000
    eval_interval: int = 10
    save_interval: int = 10
    learning_rate: float = 5e-5
    eval_iters: int = 200
    test_ratio: float = 0.2
    batch_size: int = 2
    augmentation: bool = False
    end_of_seq: bool = False
    start_of_seq: bool = False


# Vocab-sized matrices are padded to a multiple of this for kernel tiling;
# logits are sliced back to the true vocab.
VOCAB_PAD_MULTIPLE = 128


def padded_vocab(vocab_size: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Reference configs/transformer/config.yaml:1-5."""

    n_embd: int = 1024
    n_heads: int = 8
    n_layer: int = 8
    block_len: int = 2048
    dropout: float = 0.01
    vocab_size: int = VOCAB_SIZE
    metadata_vocab_size: int = DEFAULT_METADATA_VOCAB_SIZE
    vocab_pad_multiple: int = VOCAB_PAD_MULTIPLE
    # 'auto' (kernel D on CUDA, plain on CPU), 'flash' (kernel D, or its
    # plain version on CPU tensors), 'xla' (plain relpos_attention) or
    # 'torch_exact' (plain, with torch rel_shift's wrapped BD values).
    attention_impl: str = "auto"
    remat: bool = False

    @property
    def seq_len(self) -> int:  # meta prefix + tokens
        return self.block_len + NUM_META_TOKENS

    @property
    def padded_vocab(self) -> int:
        return padded_vocab(self.vocab_size, self.vocab_pad_multiple)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Reference models/mamba/mamba.py:9-25 (hard-coded values).

    d_inner = expand*d_model = 2048; nheads = d_inner//headdim = 32.
    """

    d_model: int = 1024
    n_layers: int = 10
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk_size: int = 256
    vocab_size: int = VOCAB_SIZE
    metadata_vocab_size: int = DEFAULT_METADATA_VOCAB_SIZE
    vocab_pad_multiple: int = VOCAB_PAD_MULTIPLE
    ssd_impl: str = "auto"
    # Reference quirk (models/mamba/mamba.py:32-33): layers are stacked with
    # NO inter-layer residual connections. Keep False for fidelity.
    residual: bool = False
    remat: bool = False

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ngroups * self.d_state

    @property
    def padded_vocab(self) -> int:
        return padded_vocab(self.vocab_size, self.vocab_pad_multiple)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """Reference models/xlstm/xlstm_model.py:17-42 (generator, dim 1024):
    11 blocks, sLSTM at (1, 4, 7, 10) and mLSTM elsewhere, 4 heads, conv
    k = 4, qkv blocksize 4, FFN 1.3x.

    slstm_impl is kept for field parity with the JAX package and picks
    nothing here: the sLSTM scan runs kernel H on CUDA tensors outside grad
    mode at a shape the kernel takes, and the plain scan otherwise
    (models/xlstm.runs_kernel_h)."""

    embedding_dim: int = 1024
    num_blocks: int = 11
    slstm_at: Tuple[int, ...] = (1, 4, 7, 10)
    num_heads: int = 4
    conv1d_kernel_size: int = 4
    qkv_proj_blocksize: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_ff_proj_factor: float = 1.3
    context_length: int = 2048 + NUM_META_TOKENS
    vocab_size: int = VOCAB_SIZE
    metadata_vocab_size: int = DEFAULT_METADATA_VOCAB_SIZE
    vocab_pad_multiple: int = VOCAB_PAD_MULTIPLE
    slstm_impl: str = "xla"
    remat: bool = False

    @property
    def mlstm_inner(self) -> int:
        return int(self.mlstm_proj_factor * self.embedding_dim)

    @property
    def ffn_inner(self) -> int:
        return int(self.slstm_ff_proj_factor * self.embedding_dim)

    @property
    def padded_vocab(self) -> int:
        return padded_vocab(self.vocab_size, self.vocab_pad_multiple)


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """Composer classifier = xLSTM stack at dim 512, no metadata prefix
    (reference models/classifier/model.py; musicgen_tpu/config.py
    ClassifierConfig): the generator's block layout at half its width, read
    on `context_length` tokens, its last hidden state mapped to
    `metadata_vocab_size` meta logits."""

    embedding_dim: int = 512
    num_blocks: int = 11
    slstm_at: Tuple[int, ...] = (1, 4, 7, 10)
    num_heads: int = 4
    conv1d_kernel_size: int = 4
    qkv_proj_blocksize: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_ff_proj_factor: float = 1.3
    context_length: int = 2048
    vocab_size: int = VOCAB_SIZE
    metadata_vocab_size: int = DEFAULT_METADATA_VOCAB_SIZE
    vocab_pad_multiple: int = VOCAB_PAD_MULTIPLE

    @property
    def padded_vocab(self) -> int:
        return padded_vocab(self.vocab_size, self.vocab_pad_multiple)

    @property
    def stack(self) -> XLSTMConfig:
        """The XLSTMConfig of the classifier's block stack (models/xlstm.XLSTMStack)."""
        return XLSTMConfig(
            embedding_dim=self.embedding_dim, num_blocks=self.num_blocks, slstm_at=self.slstm_at,
            num_heads=self.num_heads, conv1d_kernel_size=self.conv1d_kernel_size,
            qkv_proj_blocksize=self.qkv_proj_blocksize, mlstm_proj_factor=self.mlstm_proj_factor,
            slstm_ff_proj_factor=self.slstm_ff_proj_factor, context_length=self.context_length,
            vocab_size=self.vocab_size, metadata_vocab_size=self.metadata_vocab_size,
            vocab_pad_multiple=self.vocab_pad_multiple,
        )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The process grid of multi-rank training (musicgen_tpu/config.py
    MeshConfig): `data` is the data-parallel axis (DDP's), `model` splits
    the vocabulary-sized embedding and head over its ranks (tensor
    parallelism, parallel/mesh.py)."""

    data: int = -1  # -1 = all ranks
    model: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        return data, model


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    """The encoder-decoder tutorial translator (musicgen_tpu/models/seq2seq.py
    Seq2SeqConfig; models/seq2seq.py here): tutorial-scale defaults."""

    embed_dim: int = 256
    num_blocks: int = 2
    num_heads: int = 4
    encoder_vocab_size: int = 1024
    output_vocab_size: int = 1024
    max_len: int = 5000
    dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class Config:
    """Each model kind's default config (models/registry.py reads the field
    named after the kind) and the training values."""

    values: TrainValues = TrainValues()
    transformer: TransformerConfig = TransformerConfig()
    mamba: MambaConfig = MambaConfig()
    xlstm: XLSTMConfig = XLSTMConfig()
    classifier: ClassifierConfig = ClassifierConfig()
    seq2seq: Seq2SeqConfig = Seq2SeqConfig()


DEFAULT_CONFIG = Config()
