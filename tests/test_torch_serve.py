"""The port's serving path against ``repro.launch.serve``'s steps (CPU).

Same config (llama3.2-3b smoke, fp32), the same weights (the reference's
init, converted) and the same prompts (``jax.random.randint(key(seed+1))``,
as ``repro.launch.serve.serve`` draws them): the greedy tokens must be
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch.steps import make_prefill_step, make_serve_step
from repro.models import Model as JModel
from repro_torch._bridge import to_torch
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import generate, serve
from repro_torch.models import Model as TModel
from repro_torch.models import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The tensors here are tiny: torch's CPU thread pool costs more than it
    # saves (over 100x on a shared machine), so run them on one thread.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_tokens(jm, params, prompts, gen):
    """repro.launch.serve.serve's loop, on the given params and prompts."""
    prefill = jax.jit(make_prefill_step(jm))
    step = jax.jit(make_serve_step(jm))
    cache = jm.init_cache(prompts.shape[0], prompts.shape[1] + gen)
    next_tok, cache = prefill(params, {"tokens": prompts}, cache)
    out = [np.asarray(next_tok)[:, None]]
    tok = next_tok[:, None]
    for _ in range(gen - 1):
        tok, cache = step(params, cache, tok)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("seed,batch,prompt_len,gen", [(0, 4, 32, 16), (3, 2, 7, 5)])
def test_greedy_tokens_match_reference(seed, batch, prompt_len, gen):
    jcfg, tcfg = jget("llama3.2-3b", smoke=True), tget("llama3.2-3b", smoke=True)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(seed))
    prompts = jax.random.randint(
        jax.random.key(seed + 1), (batch, prompt_len), 0, jcfg.vocab
    ).astype(jnp.int32)
    want = _reference_tokens(jm, jp, prompts, gen)

    tm = TModel(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    res = generate(tm, tp, to_torch(prompts), gen)
    assert res["tokens"].dtype == np.int32
    np.testing.assert_array_equal(res["tokens"], want)


def test_serve_on_cpu_returns_reference_dict():
    res = serve("llama3.2-3b", smoke=True, batch=2, prompt_len=8, gen=4, device="cpu")
    assert set(res) == {"tokens", "prefill_s", "decode_s", "tok_per_s"}
    assert res["tokens"].shape == (2, 4)
    assert ((res["tokens"] >= 0) & (res["tokens"] < 512)).all()
