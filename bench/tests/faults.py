"""Faults planted under a cell's timed path, for the checks that must fail.

Each plants one fault on a driver's state after its set-up has built the
program (serve) or before its first iteration (train), so that the rest of
the run goes on as it would:

* serve: ``unchanged`` (a decode step hands back its cache as it got it),
  ``half_batch`` (the second half of the batch is given the first half's
  tokens), ``altered`` (one request's token is changed where it is made);
* train: ``unchanged`` (the update returns params and AdamW state as they
  were), ``half_batch`` (each pod's loss over half its rows), ``no_exchange``
  (the gradient sync hands every pod the first pod's gradient),
  ``altered`` (one leaf's gradient doubled where the step makes it).
"""

from __future__ import annotations

import torch


def serve_unchanged(st) -> None:
    step = st.step

    def broken(params, cache, tok):
        nxt, _ = step(params, cache, tok)
        return nxt, cache

    st.step = broken


def serve_half_batch(st) -> None:
    step = st.step

    def broken(params, cache, tok):
        nxt, cache = step(params, cache, tok)
        h = nxt.shape[0] // 2
        return torch.cat([nxt[: nxt.shape[0] - h], nxt[:h]]), cache

    st.step = broken


def serve_altered(st) -> None:
    step, vocab = st.step, st.ctx.cell.model["vocab"]

    def broken(params, cache, tok):
        nxt, cache = step(params, cache, tok)
        nxt = nxt.clone()
        nxt[0] = (nxt[0] + 1) % vocab
        return nxt, cache

    st.step = broken


def train_unchanged(tr) -> None:
    def update(grads, opt_state, params):
        zero = torch.zeros((), device=opt_state.step.device)
        return params, opt_state, {"grad_norm": zero, "lr": zero}

    tr.update_fn = update


def train_half_batch(tr) -> None:
    grad = tr.grad_fn

    def broken(params, batch):
        return grad(params, {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()})

    tr.grad_fn = broken


def train_no_exchange(tr) -> None:
    step_fns = tr.step_fns

    def broken():
        fns = step_fns()
        sync = fns["gradsync"]
        fns["gradsync"] = lambda inputs: sync({**inputs, **{f"grad_{i}": inputs["grad_0"] for i in range(tr.n_pods)}})
        return fns

    tr.step_fns = broken


def train_altered(tr) -> None:
    grad = tr.grad_fn

    def broken(params, batch):
        grads, metrics = grad(params, batch)
        q = grads["layers"][0]["mixer"]["q"]
        q["w"] = q["w"] * 2
        return grads, metrics

    tr.grad_fn = broken


SERVE = {"unchanged": serve_unchanged, "half_batch": serve_half_batch, "altered": serve_altered}
TRAIN = {"unchanged": train_unchanged, "half_batch": train_half_batch, "no_exchange": train_no_exchange,
         "altered": train_altered}
