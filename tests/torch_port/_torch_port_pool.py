"""The seeded inputs of the port's multi-rank parity tests and the starts
of four gloo ranks that run them.  ``results``: one start
(``_torch_port_workers.four_rank_pool``) whose results
test_torch_port_collectives.py and test_torch_port_compressed_optimizer.py
read, so a test process starts the ranks once for both.  ``part_results``:
one start per part of ``_torch_port_training_workers`` (overlap, adasum,
zero, sbn), of ``_torch_port_checkpoint_workers`` (ckpt), of
``_torch_port_parallel_workers`` (gspmd, ring) and of
``_torch_port_eager_workers`` (native, cache, eager, dispatch) and of
``_torch_port_modes_workers`` (units, modes, moe), of
``_torch_port_models_workers`` (resnet, bert, moet; their inputs written
by the test file's ``prepare`` hook) and of
``_torch_port_telemetry_workers`` (telemetry and hang, two ranks;
observe, four) and of
``_torch_port_recovery_workers`` (recovery) and of
``_torch_port_frontend_workers`` (frontend, two ranks) for the test
file of that part.  The ranks fork from a server that imported torch once
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
NEGOTIATED_PARTS = ("native", "cache", "eager", "dispatch")
MODEL_PARTS = ("resnet", "bert", "moet")
ZERO_PARAMS = {"w": np.linspace(-1.0, 1.0, 12, dtype=np.float32).reshape(4, 3),
               "b": np.linspace(0.5, 2.0, 16, dtype=np.float32)}


@functools.lru_cache(maxsize=None)
def part_inputs(part: str) -> dict:
    """The seeded inputs of one part, per rank along axis 0 where they
    differ between ranks (the negotiated plane's parts seed their own)."""
    if part in NEGOTIATED_PARTS or part in MODEL_PARTS or \
            part in ("telemetry", "hang", "observe", "recovery",
                     "elastic"):
        return {}
    rng = np.random.default_rng({"overlap": 11, "adasum": 12, "zero": 13,
                                 "sbn": 14, "ckpt": 15, "gspmd": 16,
                                 "ring": 17, "units": 21, "modes": 22,
                                 "moe": 23, "frontend": 31}[part])

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
    if part == "frontend":
        # Embedding rows: rank 0 looks up rows 0-4, rank 1 rows 5-9.
        idx = np.stack([rng.choice(5, (3, 3), replace=True) + 5 * r
                        for r in range(2)], axis=1)
        return {"w": normal(3, 5), "b": normal(3), "x": normal(3, 2, 4, 5),
                "emb": normal(10, 4), "idx": idx.astype(np.int64),
                "bn_x": normal(2, 4, 3, 2, scale=2.0) + 1.0,
                "bn_ct": normal(2, 4, 3, 2), "bn_w": normal(3) + 1.0,
                "bn_b": normal(3)}
    if part in ("modes", "moe"):
        tokens = rng.integers(0, 61, (8, 16))
        return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if part == "units":
        d, ff, e, t = 8, 16, 8, 16
        return {
            # tensor parallel: x (4, 8) @ w1 (8, 16) @ w2 (16, 8); h (2, 8,
            # 16) row-parallel over the sequence; seq (2, 8, 6) gathered;
            # emb (32, 8) vocab-parallel; a cotangent row per member.
            "x": normal(4, 8), "w1": normal(8, 16), "w2": normal(16, 8),
            "ct_row": normal(WORLD, 4, 8), "h": normal(2, 8, 16),
            "ct_scatter": normal(WORLD, 2, 2, 8), "seq": normal(2, 8, 6),
            "ct_gather": normal(WORLD, 2, 8, 6), "emb": normal(32, 8),
            "labels": np.array([0, 5, 17, 31]), "ct_ce": normal(WORLD, 4),
            # pipeline: 4 tanh stages of (4, 4), 4 microbatches of (2, 4).
            "ws": normal(WORLD, 4, 4, scale=0.5), "xs": normal(4, 2, 4),
            # MoE: 8 experts (2 a member), 16 tokens a member.
            "gate": normal(d, e, scale=d ** -0.5),
            "w_in": normal(e, d, ff, scale=d ** -0.5),
            "w_out": normal(e, ff, d, scale=ff ** -0.5),
            "x_moe": normal(WORLD * t, d), "ct_moe": normal(WORLD * t, d)}
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


def _spawn(body, out, world: int = WORLD):
    import torch.multiprocessing as mp
    mp.get_context("forkserver").set_forkserver_preload(
        ["torch", "torch._dynamo", "horovod_tpu_torch",
         "_torch_port_workers", "_torch_port_training_workers",
         "_torch_port_checkpoint_workers", "_torch_port_parallel_workers",
         "_torch_port_eager_workers", "_torch_port_modes_workers",
         "_torch_port_models_workers", "_torch_port_telemetry_workers",
         "_torch_port_recovery_workers", "_torch_port_elastic_workers",
         "_torch_port_frontend_workers"])
    mp.start_processes(body, args=(world, f"{out}/rendezvous", str(out)),
                       nprocs=world, join=True, start_method="forkserver")


def _save_lm(out) -> None:
    _, params, tokens, labels = lm_case()
    np.savez(os.path.join(out, "lm.npz"), cfg=json.dumps(SMALL),
             tokens=tokens, labels=labels,
             **{"param." + k: v.numpy()
                for k, v in convert.params_from_jax(params).items()})


def part_results(tmp_path_factory, part: str, prepare=None) -> list:
    """The four ranks' results of one part of
    ``_torch_port_training_workers`` (or ``_torch_port_checkpoint_workers``
    for "ckpt", ``_torch_port_parallel_workers`` for "gspmd" and "ring",
    ``_torch_port_eager_workers`` for the negotiated plane's parts,
    ``_torch_port_modes_workers`` for "units", "modes" and "moe",
    ``_torch_port_models_workers`` for "resnet", "bert" and "moet",
    ``_torch_port_recovery_workers`` for "recovery",
    ``_torch_port_elastic_workers`` for "elastic",
    ``_torch_port_frontend_workers`` for "frontend"),
    from one start of the ranks per part and test process.
    ``prepare(out_dir)`` writes what the ranks read beyond the part's
    inputs, before they start; ``part_dir(part)`` is that directory."""
    if part not in _PARTS:
        import _torch_port_checkpoint_workers as ckpt_workers
        import _torch_port_eager_workers as eager_workers
        import _torch_port_elastic_workers as el_workers
        import _torch_port_frontend_workers as fe_workers
        import _torch_port_models_workers as model_workers
        import _torch_port_modes_workers as modes_workers
        import _torch_port_parallel_workers as par_workers
        import _torch_port_recovery_workers as rec_workers
        import _torch_port_telemetry_workers as tel_workers
        import _torch_port_training_workers as workers
        out = tmp_path_factory.mktemp(f"{part}_pool")
        np.savez(os.path.join(out, f"{part}.npz"), **part_inputs(part))
        if part in ("zero", "recovery"):
            _save_lm(out)
        if prepare is not None:
            prepare(str(out))
        _DIRS[part] = str(out)
        world = tel_workers.WORLD if part in ("telemetry", "hang") \
            else fe_workers.WORLD if part == "frontend" else WORLD
        _spawn({"overlap": workers.overlap_part,
                "adasum": workers.adasum_part,
                "zero": workers.zero_part,
                "sbn": workers.sync_batch_norm_part,
                "ckpt": ckpt_workers.checkpoint_part,
                "gspmd": par_workers.gspmd_part,
                "ring": par_workers.ring_part,
                "native": eager_workers.native_part,
                "cache": eager_workers.cache_part,
                "eager": eager_workers.eager_part,
                "dispatch": eager_workers.dispatch_part,
                "units": modes_workers.units_part,
                "modes": modes_workers.modes_part,
                "moe": modes_workers.moe_part,
                "resnet": model_workers.resnet_part,
                "bert": model_workers.bert_part,
                "moet": model_workers.moet_part,
                "telemetry": tel_workers.telemetry_part,
                "hang": tel_workers.hang_part,
                "observe": tel_workers.observe_part,
                "recovery": rec_workers.recovery_part,
                "elastic": el_workers.elastic_part,
                "frontend": fe_workers.frontend_part}[part], out, world)
        _PARTS[part] = [torch.load(os.path.join(out, f"{part}{r}.pt"))
                        for r in range(world)]
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


# Controllers' ports: a block of 1000 a pytest worker, above 13000 and
# below both the reference tests' fixed ports (26000 up) and the kernel's
# ephemeral range.
PORT_BASE, PORT_TOP, PORT_BLOCK = 13000, 26000, 1000


def free_ports(n: int) -> list:
    """``n`` distinct free localhost ports, from this pytest worker's
    block.  A port that ``bind(0)`` hands out comes from the ephemeral
    range, where any socket opened before the controller binds it
    (gloo's, another worker's) may take it meanwhile; in the block only
    a chosen port is taken."""
    import random
    import socket
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        top = min(PORT_TOP, int(f.read().split()[0]))
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:]
    n_blocks = max(1, (top - PORT_BASE) // PORT_BLOCK)
    lo = PORT_BASE + PORT_BLOCK * (int(worker or 0) % n_blocks)
    ports = []
    for port in random.sample(range(lo, lo + PORT_BLOCK), PORT_BLOCK):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        ports.append(port)
        if len(ports) == n:
            return ports
    raise RuntimeError(f"no {n} free ports in {lo}-{lo + PORT_BLOCK - 1}")


def write_ports(n: int):
    """A ``prepare`` hook of ``part_results``: ``ports.json`` with ``n``
    free ports for the ranks' controllers."""
    def prepare(out):
        with open(os.path.join(out, "ports.json"), "w") as f:
            json.dump(free_ports(n), f)
    return prepare


# ---------------------------------------------------------------------------
# the parallel modes: the reference's parameters, loss and gradients
# ---------------------------------------------------------------------------

def _mode_configs(case):
    shape, cf, pf = case
    from _torch_port_modes_workers import TINY
    cfg = tfm_jax.TransformerConfig(dtype=jnp.float32,
                                    **{**TINY, "remat": False, **cf})
    return cfg, tfm_jax.ParallelConfig(*shape, **pf)


@functools.lru_cache(maxsize=None)
def _mode_params(cases_name: str, key: str):
    import _torch_port_modes_workers as W
    cases = getattr(W, cases_name)
    cfg, par = _mode_configs(cases[key])
    return tfm_jax.init_params(jax.random.PRNGKey(list(cases).index(key)),
                               cfg, par)


def write_mode_params(*cases_names: str):
    """A ``prepare`` hook of ``part_results``: ``params_<key>.npz``, the
    reference's parameters of every case of ``_torch_port_modes_workers``'
    tables ``cases_names``, as ``convert.params_from_jax`` gives them."""
    import _torch_port_modes_workers as W

    def prepare(out):
        for cases_name in cases_names:
            cases = getattr(W, cases_name)
            for key in {W.case_params_key(cases, n) for n in cases}:
                np.savez(os.path.join(out, f"params_{key}.npz"),
                         **{k: v.numpy() for k, v in convert.params_from_jax(
                             _mode_params(cases_name, key)).items()})
    return prepare


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def mode_reference(cases_name: str, name: str, part: str):
    """The reference's loss and flat gradients of one case: jitted
    ``jax.value_and_grad(make_loss_fn(cfg, par, mesh))`` on a (dp, pp,
    mp) mesh of 4 CPU devices, on the part's global batch.  The
    reference's remat changes no value, so a case with remat is held to
    the same computation without it (one compile the fewer)."""
    import _torch_port_modes_workers as W
    cases = getattr(W, cases_name)
    shape, cf, pf = cases[name]
    return _mode_reference(cases_name, W.case_params_key(cases, name), part,
                           shape,
                           tuple(sorted((k, v) for k, v in cf.items()
                                        if k != "remat")),
                           tuple(sorted(pf.items())))


@functools.lru_cache(maxsize=None)
def _mode_reference(cases_name, params_key, part, shape, cf, pf):
    from jax.sharding import Mesh
    cfg, par = _mode_configs((shape, dict(cf), dict(pf)))
    params = _mode_params(cases_name, params_key)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(
        par.dp, par.pp, par.mp), ("dp", "pp", "mp"))
    data = part_inputs(part)
    loss, grads = jax.jit(jax.value_and_grad(
        tfm_jax.make_loss_fn(cfg, par, mesh)))(
            params, jnp.asarray(data["tokens"], jnp.int32),
            jnp.asarray(data["labels"], jnp.int32))
    return float(loss), _flat_np(grads)


def _flat_specs(tree, prefix=""):
    """{path: PartitionSpec} of a reference spec tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def mode_results(tmp_path_factory, part: str, cases_name: str,
                 extra=()) -> list:
    """``part_results`` of a mode part, the reference's computations of
    its cases (and of ``extra`` tables' parameters) run meanwhile in a
    thread of this process."""
    import concurrent.futures
    import _torch_port_modes_workers as W
    cases = getattr(W, cases_name)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ref = ex.submit(lambda: [mode_reference(cases_name, n, part)
                                 for n in cases])
        out = part_results(tmp_path_factory, part,
                           prepare=write_mode_params(cases_name, *extra))
        ref.result()
    return out


MODE_LOSS_RTOL = 1e-5
# The reference's own 1F1B bar (tests/test_moe_pipeline.py:245-246).
MODE_GRAD_BAR = dict(atol=5e-5, rtol=1e-4)


def check_mode_case(ranks, cases_name: str, name: str, part: str) -> None:
    """Every rank's loss (equal on all), and the gathered gradients,
    against the reference's."""
    want_loss, want = mode_reference(cases_name, name, part)
    got = ranks[0][name]
    assert sorted(got["grads"]) == sorted(want)
    for r in ranks:
        assert torch.equal(r[name]["loss"], got["loss"])
    assert abs(float(got["loss"]) - want_loss) <= \
        MODE_LOSS_RTOL * abs(want_loss)
    for leaf, g in want.items():
        np.testing.assert_allclose(got["grads"][leaf].numpy(), g,
                                   **MODE_GRAD_BAR, err_msg=leaf)
