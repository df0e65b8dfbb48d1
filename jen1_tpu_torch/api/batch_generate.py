"""Batch text-to-music generation CLI (port of jen1_tpu/api/batch_generate.py).

  python -m jen1_tpu_torch.api.batch_generate --prompts prompts.txt --out outdir \\
      [--ckpt path] [--config cfg.json] [--seconds 30] [--steps 100] \\
      [--batch-size 4] [--use-gdm] [--seed 0] [--weights-dtype bfloat16] \\
      [--device cuda]
  torchrun --nproc_per_node N -m jen1_tpu_torch.api.batch_generate --dp N ...

One WAV per prompt line (`<index>.wav`, through `save_audio`) and a
`manifest.json` of {file, prompt}. Prompts are padded to full batches with
"" (every batch has one shape); batch b starting at prompt `start` runs with
seed `seed + start`. `--dp N > 1` shards each batch over N processes
(`Jen1.mesh`): it runs under torchrun with a world of N (NCCL on
cuda:LOCAL_RANK, gloo with --device cpu), the batch size must divide by N,
and rank 0 writes the WAVs and the manifest.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional



def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--prompts", required=True, help="text file, one prompt per line")
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--config", default=None, help="JSON config path")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--use-gdm", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", type=int, default=1,
                   help="shard each batch over this many processes (under torchrun)")
    p.add_argument("--weights-dtype", default=None, choices=("float32", "bfloat16"),
                   help="'bfloat16' stores the UNet's matrix weights in bf16")
    p.add_argument("--device", default="cuda", help="torch device of the model")
    args = p.parse_args(argv)
    if args.dp < 1 or args.batch_size % args.dp:
        raise SystemExit(f"--batch-size {args.batch_size} must be a multiple of --dp {args.dp}")

    from jen1_tpu_torch.api.generation import Jen1, save_audio
    from jen1_tpu_torch.config import Config

    device, mesh, writer, owned = args.device, None, True, False
    if args.dp > 1:
        import torch.distributed as dist

        from jen1_tpu_torch.parallel.mesh import init_distributed, make_mesh

        world = int(os.environ.get("WORLD_SIZE", dist.get_world_size()
                                   if dist.is_initialized() else 1))
        if world != args.dp:
            raise RuntimeError(f"--dp {args.dp} runs under torchrun with a world of {args.dp} "
                               f"processes (torchrun --nproc_per_node {args.dp}); this "
                               f"world has {world}")
        owned = not dist.is_initialized()
        device = init_distributed(args.device)
        mesh = make_mesh(dp=args.dp)
        writer = dist.get_rank() == 0

    config = Config.from_json(args.config) if args.config else Config()
    with open(args.prompts) as f:
        prompts = [line.strip() for line in f if line.strip()]
    if not prompts:
        raise SystemExit(f"no prompts in {args.prompts}")
    if writer:
        os.makedirs(args.out, exist_ok=True)

    jen = Jen1(args.ckpt, config=config, weights_dtype=args.weights_dtype, device=device)
    jen.mesh = mesh
    b = args.batch_size
    manifest = []
    t_start = time.perf_counter()
    for start in range(0, len(prompts), b):
        chunk = prompts[start:start + b]
        batch_prompts = chunk + [""] * (b - len(chunk))  # one shape for every batch
        t0 = time.perf_counter()
        audio = jen.generate(
            batch_prompts if len(set(batch_prompts)) > 1 else batch_prompts[0],
            seed=args.seed + start, steps=args.steps, batch_size=b,
            seconds=args.seconds, use_gdm=args.use_gdm,
        )
        wall = time.perf_counter() - t0
        if not writer:
            continue
        for i, prompt in enumerate(chunk):
            name = f"{start + i:05d}.wav"
            save_audio(audio[i], os.path.join(args.out, name), sample_rate=jen.sample_rate)
            manifest.append({"file": name, "prompt": prompt})
        print(f"batch {start // b}: {len(chunk)} clips in {wall:.2f}s "
              f"({len(chunk) * args.seconds / wall:.1f} audio_s/s)", flush=True)
    if owned:
        dist.destroy_process_group()
    if not writer:
        return
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    total = time.perf_counter() - t_start
    print(f"done: {len(prompts)} clips, {len(prompts) * args.seconds / total:.1f} "
          f"audio_s/s overall -> {args.out}")


if __name__ == "__main__":
    main()
