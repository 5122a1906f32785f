"""The seeded inputs of the port's multi-rank parity tests and the starts
of four gloo ranks that run them.  ``results``: one start
(``_torch_port_workers.four_rank_pool``) whose results
test_torch_port_collectives.py and test_torch_port_compressed_optimizer.py
read, so a test process starts the ranks once for both.  ``part_results``:
one start per part of ``_torch_port_training_workers`` (overlap, adasum,
zero, sbn), of ``_torch_port_checkpoint_workers`` (ckpt) and of
``_torch_port_parallel_workers`` (gspmd, ring) for the test file of that
part.  The ranks fork from a server that imported torch once
for all four."""

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


LEAF_SHAPES = [(7, 300), (300,), (2, 3, 130), (40,), (513,)]
BF16_LEAF = 3
GATHER_SHAPES = [(5, 7), (33,), (3, 4, 5)]
GSPMD_PARAMS = {"param.w": np.linspace(-1.0, 1.0, 96, dtype=np.float32)
                .reshape(32, 3),
                "param.b": np.linspace(0.5, 2.0, 16, dtype=np.float32),
                "param.c": np.linspace(0.0, 1.0, 5, dtype=np.float32)}
ZERO_PARAMS = {"w": np.linspace(-1.0, 1.0, 12, dtype=np.float32).reshape(4, 3),
               "b": np.linspace(0.5, 2.0, 16, dtype=np.float32)}


@functools.lru_cache(maxsize=None)
def part_inputs(part: str) -> dict:
    """The seeded inputs of one part, per rank along axis 0 where they
    differ between ranks."""
    rng = np.random.default_rng({"overlap": 11, "adasum": 12, "zero": 13,
                                 "sbn": 14, "ckpt": 15, "gspmd": 16,
                                 "ring": 17}[part])

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if part == "overlap":
        out = {f"leaf{i}": normal(WORLD, *s, scale=3.0)
               for i, s in enumerate(LEAF_SHAPES)}
        out.update({f"param{i}": normal(*s) for i, s in
                    enumerate(GATHER_SHAPES)})
        out.update({f"ct{i}": normal(WORLD, *s) for i, s in
                    enumerate(GATHER_SHAPES)})
        return dict(out, n_leaves=len(LEAF_SHAPES), bf16=BF16_LEAF,
                    n_params=len(GATHER_SHAPES))
    if part == "adasum":
        base = normal(1000)
        # Correlated contributions: Adasum's coefficients are then far
        # from the plain sum's.
        x = np.stack([base * (0.5 + r) + normal(1000) for r in range(WORLD)])
        # z (1002) and t (2, 5): node shards of odd length (501, 5), which
        # the cross ladder pads to a multiple of its size.
        return {"x": x.astype(np.float32), "y": normal(WORLD, 3, 130),
                "w": normal(50), "g": normal(2, WORLD, 50),
                "z": normal(WORLD, 1002), "t": normal(WORLD, 2, 5)}
    if part == "ckpt":
        return {"param.w": np.linspace(-1.0, 1.0, 12, dtype=np.float32)
                .reshape(4, 3),
                "param.b": np.linspace(0.5, 2.0, 10, dtype=np.float32),
                "param.layers.u": normal(2, 3),
                "param.layers.a": normal(7),
                "x": normal(WORLD, 1, 4, scale=2.0)}
    if part == "gspmd":
        return dict(GSPMD_PARAMS, x=normal(WORLD, 2, 32),
                    sched_x=normal(WORLD, 5, 130, scale=3.0),
                    sched_rs=normal(WORLD, 8, 33), sched_v=normal(WORLD, 2,
                                                                 3, 50))
    if part == "ring":
        # (B, S, H, D) over the whole sequence; 4 heads split over 4
        # members, 64 rows a member (one tile of the reference's kernel).
        return {n: normal(1, 256, 4, 32) for n in ("q", "k", "v", "ct")}
    if part == "zero":
        # Per-rank distinct rows, so the mean over ranks is a reduction.
        return dict(ZERO_PARAMS, x=np.arange(WORLD * 4, dtype=np.float32)
                    .reshape(WORLD, 1, 4))
    return {"x": normal(WORLD, 8, 5, 16, scale=2.0) + 1.0,
            "ct": normal(WORLD, 8, 5, 16), "scale": normal(16) + 1.0,
            "bias": normal(16), "rm": normal(16),
            "rv": np.abs(normal(16)) + 0.5}


_RESULTS = {}
_PARTS = {}
_DIRS = {}


def part_dir(part: str) -> str:
    """The directory the ranks of ``part`` read and wrote."""
    return _DIRS[part]


def _spawn(body, out):
    import torch.multiprocessing as mp
    mp.get_context("forkserver").set_forkserver_preload(
        ["torch", "torch._dynamo", "horovod_tpu_torch",
         "_torch_port_workers", "_torch_port_training_workers",
         "_torch_port_checkpoint_workers", "_torch_port_parallel_workers"])
    mp.start_processes(body, args=(WORLD, f"{out}/rendezvous", str(out)),
                       nprocs=WORLD, join=True, start_method="forkserver")


def _save_lm(out) -> None:
    _, params, tokens, labels = lm_case()
    np.savez(os.path.join(out, "lm.npz"), cfg=json.dumps(SMALL),
             tokens=tokens, labels=labels,
             **{"param." + k: v.numpy()
                for k, v in convert.params_from_jax(params).items()})


def part_results(tmp_path_factory, part: str, prepare=None) -> list:
    """The four ranks' results of one part of
    ``_torch_port_training_workers`` (or ``_torch_port_checkpoint_workers``
    for "ckpt", ``_torch_port_parallel_workers`` for "gspmd" and "ring"),
    from one start of the ranks per part and test process.
    ``prepare(out_dir)`` writes what the ranks read beyond the part's
    inputs, before they start; ``part_dir(part)`` is that directory."""
    if part not in _PARTS:
        import _torch_port_checkpoint_workers as ckpt_workers
        import _torch_port_parallel_workers as par_workers
        import _torch_port_training_workers as workers
        out = tmp_path_factory.mktemp(f"{part}_pool")
        np.savez(os.path.join(out, f"{part}.npz"), **part_inputs(part))
        if part == "zero":
            _save_lm(out)
        if prepare is not None:
            prepare(str(out))
        _DIRS[part] = str(out)
        _spawn({"overlap": workers.overlap_part,
                "adasum": workers.adasum_part,
                "zero": workers.zero_part,
                "sbn": workers.sync_batch_norm_part,
                "ckpt": ckpt_workers.checkpoint_part,
                "gspmd": par_workers.gspmd_part,
                "ring": par_workers.ring_part}[part], out)
        _PARTS[part] = [torch.load(os.path.join(out, f"{part}{r}.pt"))
                        for r in range(WORLD)]
    return _PARTS[part]


def results(tmp_path_factory) -> dict:
    """{"collectives": 4 ranks' results, "uneven": 3, "optimizer": 2,
    "feedback": 1}, from one start of the ranks per test process."""
    if not _RESULTS:
        import _torch_port_workers as workers
        out = tmp_path_factory.mktemp("four_rank_pool")
        np.savez(os.path.join(out, "inputs.npz"), **collective_inputs())
        np.savez(os.path.join(out, "opt.npz"), **optimizer_data())
        _save_lm(out)
        _spawn(workers.four_rank_pool, out)
        for name, world in (("collectives", WORLD), ("uneven", UNEVEN_WORLD),
                            ("optimizer", OPT_WORLD), ("feedback", 1)):
            _RESULTS[name] = [torch.load(os.path.join(out, f"{name}{r}.pt"))
                              for r in range(world)]
    return _RESULTS
