"""Serving (``repro_torch.launch.serve``) against the reference's
``repro.launch.serve.main``, on the CPU.

The reference's ``main`` draws its parameters with
``jax.random.PRNGKey(0)`` and its prompt with ``make_train_batch(...,
seed=1)``; the port's :func:`generate` gets the same parameters through
``convert.params_from_reference`` and the same prompt from its own
``make_train_batch``. Tolerance: the greedy tokens are **equal**, every
step of every sequence, for every architecture (the float32 logits agree
to 1e-3 of their largest magnitude or closer,
``tests/test_torch_model_archs.py``, and no step's top two logits are
that close here). The MoE archs serve at their published capacity factor,
so the prefill drops the reference's pairs; the vlm at its initial gates
(zero, as the reference's ``main`` runs it); the audio family from the
encoded frames and token 0, with no prefill.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import build_model

PROMPT, GEN = 10, 8


@pytest.mark.parametrize("arch, batch", [("h2o-danube-1.8b", 4), ("qwen2.5-32b", 2),
                                         ("command-r-35b", 3), ("gemma3-1b", 4),
                                         ("mixtral-8x7b", 3), ("deepseek-v2-lite-16b", 4),
                                         ("recurrentgemma-9b", 2), ("mamba2-780m", 4),
                                         ("llama-3.2-vision-11b", 2), ("whisper-large-v3", 3)])
def test_greedy_tokens_equal_the_reference_main(arch, batch):
    flags = ["--arch", arch, "--smoke", "--batch", str(batch), "--prompt-len", str(PROMPT),
             "--gen", str(GEN)]
    with contextlib.redirect_stdout(io.StringIO()):
        want = jserve.main(flags)

    cfg = get_config(arch, smoke=True)
    jparams = jbuild_model(jget_config(arch, smoke=True)).init(jax.random.PRNGKey(0))
    params = convert.params_from_reference(jax.tree_util.tree_map(np.asarray, jparams),
                                           device="cpu")
    prompt = make_train_batch(cfg, batch, PROMPT, seed=1, device="cpu")
    prompt.pop("labels")
    out = serve.generate(build_model(cfg), params, prompt, prompt_len=PROMPT, gen=GEN)
    assert out.tokens.shape == (batch, GEN)
    assert np.array_equal(out.tokens, np.asarray(want))
    assert len(out.logits) == GEN and out.logits[0].shape == (batch, cfg.vocab_size)
    assert out.prefill_s > 0 and out.decode_s > 0


def test_main_serves_on_the_cpu_when_asked():
    flags = ["--arch", "gemma3-1b", "--smoke", "--batch", "2", "--prompt-len", "6", "--gen", "3",
             "--device", "cpu"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        toks = serve.main(flags)
    assert toks.shape == (2, 3) and toks.dtype == np.int32
    assert "device=cpu" in text.getvalue()


def test_sampling_draws_from_the_generator():
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    prompt = make_train_batch(cfg, 2, 6, seed=1, device="cpu")

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return serve.generate(model, params, prompt, prompt_len=6, gen=5, temperature=1.5,
                              generator=gen).tokens

    assert np.array_equal(sample(7), sample(7))
    assert ((sample(7) >= 0) & (sample(7) < cfg.vocab_size)).all()


def test_generate_restores_the_matmul_precision():
    cfg = get_config("gemma3-1b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = make_train_batch(cfg, 1, 4, seed=1, device="cpu")
    before = torch.get_float32_matmul_precision()
    serve.generate(model, params, prompt, prompt_len=4, gen=1)
    assert torch.get_float32_matmul_precision() == before


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b", "mamba2-780m"])
def test_main_serves_every_family_on_the_cpu(arch):
    flags = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "5", "--gen", "3",
             "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        toks = serve.main(flags)
    assert toks.shape == (2, 3) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < get_config(arch, smoke=True).vocab_size)).all()


def test_audio_generation_decodes_from_token_zero():
    cfg = get_config("whisper-large-v3", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_train_batch(cfg, 2, 0, seed=1, device="cpu")  # frames, no prompt tokens
    out = serve.generate(model, params, batch, prompt_len=0, gen=4)
    assert out.first.tolist() == [0, 0] and out.tokens.shape == (2, 4)
    # each step's logits are the teacher-forced decoder's over the fed tokens
    fed = torch.cat([torch.zeros((2, 1), dtype=torch.int32), torch.from_numpy(out.tokens[:, :-1])],
                    dim=1)
    full = model.forward(params, {"frames": batch["frames"], "tokens": fed})
    for i, step in enumerate(out.logits):
        rel = (step - full[:, i]).abs().max() / full[:, i].abs().max()
        assert rel < 2e-3, (i, float(rel))
