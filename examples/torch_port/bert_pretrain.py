"""BERT masked-LM pretraining on synthetic data on the port (the
counterpart of examples/bert_pretrain.py): data-parallel over the world
(dp), with optional tensor parallelism (mp) on a (dp, mp) mesh.

    hvdrun-torch -np 4 python examples/torch_port/bert_pretrain.py --mp 2
    python examples/torch_port/bert_pretrain.py --device cpu --layers 1
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models import bert  # noqa: E402
from horovod_tpu_torch.parallel.mesh import create_mesh  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-per-rank", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--dense-head", action="store_true",
                    help="compute MLM logits at every position instead "
                         "of the default gathered masked-position head "
                         "(real-BERT max_predictions_per_seq)")
    ap.add_argument("--device", default=None,
                    help="cpu to compute on the CPU over gloo")
    args = ap.parse_args()

    hvd.init(device=args.device)
    dev, n = hvd.device(), hvd.size()
    if n % args.mp:
        raise SystemExit(f"--mp {args.mp} does not divide the world ({n})")
    mesh = create_mesh({"dp": n // args.mp, "mp": args.mp})
    cfg = bert.BertConfig(
        vocab_size=8192, d_model=args.d_model, n_heads=8,
        d_ff=4 * args.d_model, n_layers=args.layers, seq_len=args.seq_len,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        remat=False)
    model = bert.Bert(cfg, seed=0, device=dev, mesh=mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
    gathered = not args.dense_head
    step = bert.make_train_step(cfg, model, opt, gathered=gathered)

    # This rank's dp rows: the same batch on the members of one mp group.
    dp_rank = hvd.rank() // args.mp
    for i in range(args.steps):
        seed = 1 + i * (n // args.mp) + dp_rank
        batch = (bert.synthetic_mlm_batch if gathered
                 else bert.synthetic_batch)(cfg, args.batch_per_rank,
                                            seed=seed, device=dev)
        t0 = time.perf_counter()
        loss = float(step(*batch))
        if hvd.rank() == 0:
            print(f"step {i:3d}  mlm_loss {loss:.4f}  "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    hvd.shutdown()


if __name__ == "__main__":
    main()
