"""The pieces of the port's multi-rank strategies that need no group of
several ranks: default_microbatches equal to the JAX package's over a grid
of (batch, stages); pp_split / pp_join round-tripping a state dict bit for
bit and in order (Mamba and the Transformer); the vocabulary split; and
every refusal: the pipeline's (layers that do not divide over the stages, a
batch that does not divide into the microbatches, a microbatch that does not
divide over the data axis, an xLSTM), the grids' (a group of the wrong
size) and cli.train's (--pp for an xLSTM, --sp but for Mamba, --tp without
--parallel, --multihost without a strategy or a launcher, augmentation,
a launcher's group of the wrong size)."""
import pytest
import torch
import torch.distributed as dist

from musicgen_tpu.parallel.pipeline import default_microbatches as jax_default_microbatches
from musicgen_tpu_torch.cli import train as train_cli
from musicgen_tpu_torch.config import MambaConfig, MeshConfig, TransformerConfig, XLSTMConfig
from musicgen_tpu_torch.models import mamba, transformer
from musicgen_tpu_torch.parallel import mesh, pipeline
from tests import torch_ddp_common as ddp

SMALL = {"mamba": MambaConfig(d_model=32, n_layers=4, d_state=8, headdim=8, chunk_size=8, metadata_vocab_size=9),
         "transformer": TransformerConfig(n_embd=32, n_heads=4, n_layer=4, block_len=26, metadata_vocab_size=9)}
MODULES = {"mamba": mamba, "transformer": transformer}


def small_model(name: str):
    return MODULES[name].init_weights_(MODULES[name].empty_model(SMALL[name], "cpu"), 0)


def test_default_microbatches_match_jax():
    for batch in range(1, 41):
        for stages in range(1, 9):
            assert pipeline.default_microbatches(batch, stages) == jax_default_microbatches(batch, stages)


@pytest.mark.parametrize("name", ["mamba", "transformer"])
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_pp_split_join_roundtrip(name, stages):
    model = small_model(name)
    sd = model.state_dict()
    parts = pipeline.pp_split(sd, SMALL[name], stages)
    assert len(parts) == stages
    back = pipeline.pp_join(parts)
    assert list(back) == list(sd)
    assert all(back[k] is v for k, v in sd.items())
    for i, part in enumerate(parts):  # a stage's own state dict is its part, in the same order
        assert list(pipeline.PipelineStage(model, stages, i).state_dict()) == list(part)


def test_vocab_range():
    assert [mesh.vocab_range(17914, 4, i) for i in range(4)] == [(0, 4479), (4479, 8958), (8958, 13437),
                                                                  (13437, 17914)]
    assert [mesh.vocab_range(17914, 2, i) for i in range(2)] == [(0, 8957), (8957, 17914)]
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        mesh.vocab_range(9, 4, 0)


def test_pipeline_refusals():
    with pytest.raises(ValueError, match="n_layers 4 must divide over the 'pipe' axis size 3"):
        pipeline.PipelineStage(small_model("mamba"), 3, 0)
    with pytest.raises(ValueError, match="Mamba and the Transformer only"):
        pipeline.pp_split({}, XLSTMConfig(), 2)
    stage = pipeline.PipelineStage(small_model("mamba"), 1, 0)
    src = torch.zeros(4, 26, dtype=torch.long)
    meta = torch.zeros(4, 6, dtype=torch.long)
    with pytest.raises(ValueError, match="batch 4 must divide into 3 microbatches"):
        pipeline.pp_loss(stage, src, src, meta, pipeline.PipeGrid(1, 1, 0), 3)
    with pytest.raises(ValueError, match="microbatch 1 must divide the 'data' axis size 2"):
        pipeline.pp_loss(stage, src, src, meta, pipeline.PipeGrid(1, 2, 0), 4)


@pytest.fixture
def one_rank(monkeypatch):
    """A 1-rank gloo group of this process with a launcher's environment."""
    ddp.set_rank_env(0, 1, ddp.free_port())
    dist.init_process_group("gloo", init_method="env://")
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)


def test_grid_refusals(one_rank):
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 3"):
        mesh.make_grid(MeshConfig(model=3))
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2"):
        pipeline.make_pipe_grid(2)
    grid = mesh.make_grid(MeshConfig())
    assert (grid.data, grid.model, grid.data_index, grid.model_index) == (1, 1, 0, 0)


def cli(*extra, model="mamba"):
    return ["--model", model, "--data", "unused", "--metadata", "unused", "--device", "cpu", *extra]


def test_cli_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="--pp implements the mamba and transformer steps only"):
        train_cli.main(cli("--pp", "2", model="xlstm"))
    with pytest.raises(SystemExit, match="--sp implements the mamba step only"):
        train_cli.main(cli("--sp", "2", model="transformer"))
    with pytest.raises(ValueError, match="--tp splits the vocabulary over the ranks of --parallel"):
        train_cli.main(cli("--tp", "2"))
    with pytest.raises(ValueError, match="--multihost joins a launcher's group"):
        train_cli.main(cli("--multihost"))
    with pytest.raises(ValueError, match="--pp trains without augmentation"):
        train_cli.main(cli("--pp", "2", "--augmentation"))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for flags in (("--multihost", "--pp", "2"), ("--sp", "2"), ("--multihost", "--parallel", "--tp", "2")):
        with pytest.raises(RuntimeError, match="launcher"):
            train_cli.main(cli(*flags))


@pytest.mark.parametrize("flag", ["--pp", "--sp"])
def test_cli_refuses_a_group_of_the_wrong_size(monkeypatch, flag):
    """A launcher's group of 1 for a strategy of 2 ranks: cli.train names
    torchrun's --nproc_per_node and leaves no group behind."""
    ddp.set_rank_env(0, 1, ddp.free_port())
    try:
        with pytest.raises(ValueError, match=f"{flag} 2 needs a group of 2 ranks, the launcher's has 1: torchrun "
                                             "--nproc_per_node 2"):
            train_cli.main(cli(flag, "2"))
        assert not dist.is_initialized()
    finally:
        for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(k, raising=False)


def test_one_stage_and_one_rank_are_the_plain_step():
    """--pp 1 and --sp 1 choose the one-process step, as JAX's `if args.pp >
    1`; a pipeline of one stage holds the whole model."""
    for flags in (("--pp", "1"), ("--sp", "1"), ()):
        assert train_cli.strategy(train_cli.parse_args(cli(*flags))) is None
    model = small_model("transformer")
    assert list(pipeline.PipelineStage(model, 1, 0).state_dict()) == list(model.state_dict())
