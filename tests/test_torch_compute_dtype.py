"""The compute dtype of the port's models (models/compute.py): the f32
default of every family keeps the bits of the code before the dtype was
threaded through and makes no tensor of another dtype; a bf16 model keeps
f32 parameters, gradients and state dict, and its step takes kernel D/E's
wrappers on bf16 activations."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from musicgen_tpu_torch.config import MambaConfig, TransformerConfig, XLSTMConfig
from musicgen_tpu_torch.models import mamba, transformer, xlstm
from musicgen_tpu_torch.ops import attention_kernel
from musicgen_tpu_torch.train.loss import filtered_cross_entropy
from tests.torch_bf16_common import META, batch

torch.set_num_threads(1)

SMALL = {
    "mamba": (mamba, MambaConfig(d_model=64, n_layers=2, d_state=16, headdim=16, chunk_size=16,
                                 metadata_vocab_size=META)),
    "transformer": (transformer, TransformerConfig(n_embd=64, n_heads=2, n_layer=2, block_len=32, dropout=0.0,
                                                   metadata_vocab_size=META, attention_impl="flash")),
    "xlstm": (xlstm, XLSTMConfig(embedding_dim=64, num_blocks=2, slstm_at=(1,), num_heads=2,
                                 metadata_vocab_size=META)),
}


def _forward_backward(model):
    model.zero_grad(set_to_none=True)
    src, trg, meta = (torch.from_numpy(x) for x in batch(10))
    logits = model(src, meta)
    filtered_cross_entropy(src, logits, trg).backward()
    return [logits.detach()] + [p.grad for p in model.parameters()]


class _Conversions(TorchDispatchMode):
    """Records the dtypes of every floating tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.dtypes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if torch.is_tensor(t) and t.is_floating_point():
                self.dtypes.add(t.dtype)
        return out


@pytest.mark.parametrize("family", list(SMALL))
def test_f32_default_keeps_its_bits(family, monkeypatch):
    """The f32 model's logits and gradients, bit for bit, with the compute
    dtype's helpers (models/compute.py) replaced by the bare module calls
    the models made before; and no op of the f32 forward or backward makes
    a tensor of another floating dtype."""
    module, cfg = SMALL[family]
    model = module.init_weights_(module.empty_model(cfg, "cpu"), 0)
    with _Conversions() as seen:
        got = _forward_backward(model)
    # kernel D/E's plain versions round q, k, v, p and dS to bf16, as the kernels do
    assert seen.dtypes == ({torch.float32, torch.bfloat16} if family == "transformer" else {torch.float32})
    monkeypatch.setattr(module, "dense", lambda layer, x, dtype: layer(x))
    monkeypatch.setattr(module, "embed", lambda table, ids, dtype: table(ids))
    monkeypatch.setattr(module, "layer_norm", lambda norm, x, dtype: norm(x))
    want = _forward_backward(model)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("family", list(SMALL))
def test_bf16_model_keeps_f32_state(family, monkeypatch):
    """A bf16 model: logits in f32 (the f32 lm_head), f32 gradients, a state
    dict equal in keys and dtypes to the f32 model's; a Transformer's
    training forward reaches kernel D/E's wrapper with bf16 q, k, v and rel
    and gets a bf16 output back."""
    module, cfg = SMALL[family]
    model = module.init_weights_(module.empty_model(cfg, "cpu", torch.bfloat16), 0)
    seen, kernel_in = [], []
    wrapper, apply = transformer.flash_relpos_attention_train, attention_kernel.FlashRelposAttention.apply

    def spy(*a):
        out = wrapper(*a)
        seen.append(([x.dtype for x in a[:4]], out.dtype))
        return out

    monkeypatch.setattr(transformer, "flash_relpos_attention_train", spy)
    monkeypatch.setattr(attention_kernel.FlashRelposAttention, "apply",
                        lambda *a: kernel_in.append([x.dtype for x in a[:4]]) or apply(*a))
    src, trg, meta = (torch.from_numpy(x) for x in batch(10))
    logits = model(src, meta)
    assert logits.dtype == torch.float32
    filtered_cross_entropy(src, logits, trg).backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters())
    ref = module.empty_model(cfg, "cpu").state_dict()
    assert {k: v.dtype for k, v in model.state_dict().items()} == {k: v.dtype for k, v in ref.items()}
    layers = cfg.n_layer if family == "transformer" else 0
    assert seen == [([torch.bfloat16] * 4, torch.bfloat16)] * layers
    assert kernel_in == [[torch.float32] * 4] * layers  # upcast around the kernels, as the TPU wrapper
