"""horovod_tpu_torch's flagship with switch-MoE MLPs, experts over dp,
against horovod_tpu's ``make_loss_fn`` under ``shard_map``.

The tiny flagship (fp32, vocab 61, d 32, 4 heads, d_ff 48, seq 16, 2
layers, a global batch of 8) with MoE MLPs and the reference's parameters
runs on four gloo ranks (``_torch_port_pool.part_results("moe")``, bodies
in ``_torch_port_modes_workers.py``): (dp, pp, mp) = (4, 1, 1) with 8
experts (2 a rank) and (2, 1, 2) with 4 experts (2 a rank, the sequence
split over mp), at top_k 1 and 2 (the last with remat), capacity factor
1.25, so that routes drop.  The bars of test_torch_port_modes.py: the
loss at rtol 1e-5, every gathered gradient leaf at atol 5e-5, rtol 1e-4.
The experts' gradients are summed over mp only, the gate's and the
tokens' reach them through the differentiable all-to-all: a cut graph
fails the gate and the attention weights."""

import pytest

import _torch_port_modes_workers as W
import _torch_port_pool as pool


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.mode_results(tmp_path_factory, "moe", "MOE_CASES")


@pytest.mark.parametrize("name", list(W.MOE_CASES))
def test_moe_mode_matches_reference(ranks, name):
    pool.check_mode_case(ranks, "MOE_CASES", name, "moe")


def test_shards_gather_back_to_the_tree(ranks):
    for r in ranks:
        assert r["roundtrip"]
