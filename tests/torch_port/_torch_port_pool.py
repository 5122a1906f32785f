"""The seeded inputs of the port's multi-rank parity tests and the one
start of four gloo ranks that runs them (``_torch_port_workers
.four_rank_pool``): test_torch_port_collectives.py and
test_torch_port_compressed_optimizer.py read its results, so a test
process starts the ranks once for both, and they fork from a server that
imported torch once for all four."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu.models import transformer as tfm_jax
from horovod_tpu_torch import convert

WORLD = 4          # the collectives' world; the optimizer's is ranks 0-1
OPT_WORLD = 2
UNEVEN_WORLD = 3
SMALL = dict(vocab_size=128, d_model=64, n_heads=4, d_ff=128, n_layers=2,
             seq_len=64)


@functools.lru_cache(maxsize=None)
def collective_inputs():
    """Per rank: x (5, 130) for allreduce, rs (8, 33) for reducescatter,
    ag (3, 50) for allgather."""
    rng = np.random.default_rng(4)
    return {"x": (rng.standard_normal((WORLD, 5, 130)) * 3).astype(np.float32),
            "rs": rng.standard_normal((WORLD, 8, 33)).astype(np.float32),
            "ag": rng.standard_normal((WORLD, 3, 50)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def optimizer_data():
    """Parameters w (7, 300), b (300) and per pass, per rank gradients:
    3 steps at bpps 1, 6 passes at bpps 2."""
    rng = np.random.default_rng(6)
    n = 6
    return {"w": rng.standard_normal((7, 300)).astype(np.float32),
            "b": rng.standard_normal(300).astype(np.float32),
            "g_w": rng.standard_normal((n, OPT_WORLD, 7, 300)
                                       ).astype(np.float32),
            "g_b": (rng.standard_normal((n, OPT_WORLD, 300)) * 1e-2
                    ).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def lm_case():
    """The small transformer's reference parameters and one batch."""
    cfg = tfm_jax.TransformerConfig(dtype=jnp.float32, **SMALL)
    params = tfm_jax.init_params(jax.random.PRNGKey(2), cfg,
                                 tfm_jax.ParallelConfig())
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, SMALL["vocab_size"], (4, SMALL["seq_len"]))
    return cfg, params, tokens, np.roll(tokens, -1, axis=1)


_RESULTS = {}


def results(tmp_path_factory) -> dict:
    """{"collectives": 4 ranks' results, "uneven": 3, "optimizer": 2,
    "feedback": 1}, from one start of the ranks per test process."""
    if not _RESULTS:
        import torch.multiprocessing as mp
        import _torch_port_workers as workers
        out = tmp_path_factory.mktemp("four_rank_pool")
        np.savez(os.path.join(out, "inputs.npz"), **collective_inputs())
        np.savez(os.path.join(out, "opt.npz"), **optimizer_data())
        _, params, tokens, labels = lm_case()
        np.savez(os.path.join(out, "lm.npz"), cfg=json.dumps(SMALL),
                 tokens=tokens, labels=labels,
                 **{"param." + k: v.numpy()
                    for k, v in convert.params_from_jax(params).items()})
        # The ranks fork from a server that imported torch (and what the
        # first optimizer's construction imports) once for all four; the
        # server never imports JAX.
        mp.get_context("forkserver").set_forkserver_preload(
            ["torch", "torch._dynamo", "horovod_tpu_torch",
             "_torch_port_workers"])
        mp.start_processes(workers.four_rank_pool,
                           args=(WORLD, f"{out}/rendezvous", str(out)),
                           nprocs=WORLD, join=True,
                           start_method="forkserver")
        for name, world in (("collectives", WORLD), ("uneven", UNEVEN_WORLD),
                            ("optimizer", OPT_WORLD), ("feedback", 1)):
            _RESULTS[name] = [torch.load(os.path.join(out, f"{name}{r}.pt"))
                              for r in range(world)]
    return _RESULTS
