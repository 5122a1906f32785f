"""The flagship transformer LM trained data-parallel on the port (the
counterpart of examples/jax_transformer_lm.py), fed by the port's
``DataLoader``.

    hvdrun-torch -np 2 python examples/torch_port/transformer_lm.py
    python examples/torch_port/transformer_lm.py --overlap
    python examples/torch_port/transformer_lm.py --zero-stage 3

By default the gradients go through ``horovod_tpu_torch.torch``'s
``DistributedOptimizer``: each one's allreduce fires from its hook
during backward.  ``--overlap`` takes the port's bucketed
``DistributedOptimizer(overlap=True)`` (the gradients leave in
size-bounded buckets from the hooks), ``--zero-stage`` the port's
``ZeroShardedOptimizer`` (1: optimizer-state shards, 2: + gradient
shards, 3: + parameter shards gathered for the forward).  The losses
are the same on every path; only the wire's schedule and what a rank
holds change.  Pipeline, tensor and expert parallelism run on the
port's mesh (``models.transformer.Transformer(cfg, par, mesh=)``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import horovod_tpu_torch as hvd_port  # noqa: E402
import horovod_tpu_torch.torch as hvd  # noqa: E402
from horovod_tpu_torch import data as hvd_data  # noqa: E402
from horovod_tpu_torch.models import transformer as tfm  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--overlap", action="store_true",
                   help="the bucketed schedule: each bucket's allreduce "
                        "starts from backward's hooks")
    p.add_argument("--zero-stage", type=int, default=0,
                   choices=[0, 1, 2, 3],
                   help="ZeRO weight-update sharding over the world; "
                        "0 = off")
    p.add_argument("--device", default=None,
                   help="cpu to compute on the CPU over gloo")
    args = p.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()
    cfg = tfm.TransformerConfig(
        vocab_size=2048, d_model=args.d_model, n_heads=8,
        d_ff=4 * args.d_model, n_layers=args.layers, seq_len=args.seq,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    par = tfm.ParallelConfig()
    model = tfm.Transformer(cfg, par, seed=0, device=dev)

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4)

    if args.zero_stage:
        opt = hvd_port.ZeroShardedOptimizer(model, adamw,
                                            stage=args.zero_stage,
                                            overlap=args.overlap or None)
    elif args.overlap:
        opt = hvd_port.DistributedOptimizer(adamw(model.parameters()),
                                            overlap=True)
    else:
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            adamw(model.parameters()),
            named_parameters=model.named_parameters())
    step = tfm.make_train_step(cfg, par, model, opt)

    # A small synthetic corpus, each rank its shard of the sequences, the
    # next batch gathered while the step runs.
    tokens, labels = tfm.synthetic_batch(cfg, args.batch * hvd.size() * 4,
                                         seed=1, device="cpu")
    loader = hvd_data.DataLoader(
        hvd_data.ArraySource(tokens.numpy(), labels.numpy()),
        batch_size=args.batch, shuffle=False, policy=hvd_data.DROP,
        device=dev)
    it = iter(loader)
    for i in range(args.steps):
        try:
            tok, lab = next(it)
        except StopIteration:
            it = iter(loader)
            tok, lab = next(it)
        loss = step(tok, lab)
        if hvd.rank() == 0:
            print(f"step {i}: loss {float(loss):.4f}")
    loader.close()
    hvd.shutdown()


if __name__ == "__main__":
    main()
