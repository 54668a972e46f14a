"""The readings a cell's limits are set from, at the cell's own size, in
one process: the program's numbers (what `correct` compares) over many
seeds, and the control's, the reference in bfloat16 put in the program's
place, over a few.

    python3 raybench/readings.py --workload <name> --seeds 12 --control-seeds 3

Prints one JSON line a seed and, last, the largest sound reading and the
smallest control reading of each number. A limit goes between them
(PERF.md says where each was set).
"""
import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from raybench.lib import bench

    bench.env_for_caches(ROOT)
    if not torch.cuda.is_available():
        print("raybench: readings are taken on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    spec = bench.cell_spec(ROOT, args.workload)
    ref = spec.reference
    rng = random.Random(args.first_seed if args.first_seed is not None else time.time_ns())
    seeds = [rng.randrange(2**31, 2**32) for _ in range(args.seeds + args.control_seeds)]
    settings = bench.render_settings(spec)
    sound, control = {}, {}
    prog, prog_arrays = None, None
    for i, seed in enumerate(seeds):
        arrays = bench.scene_arrays(spec, seed)
        sseed = bench.sampler_base(seed)
        is_control = i >= args.seeds
        if is_control:
            if spec.traffic["kind"] == "render_grad":
                keep = ref.loss_and_grads(arrays, settings, spec.traffic["params"],
                                          bench.make_target(spec, seed, dev), sseed, dev,
                                          torch.bfloat16)
            else:
                pid = torch.as_tensor(bench.pixel_sample(spec, seed), device=dev)
                keep = ref.frame_pixels(arrays, settings, pid, sseed, dev,
                                        torch.bfloat16).cpu().numpy()
        else:
            same = prog_arrays is not None and all(
                (a == b).all() for a, b in zip(_flat(arrays), _flat(prog_arrays)))
            if not same:
                prog, prog_arrays = bench.Program(spec, seed, dev, arrays), arrays
                for j in range(spec.traffic["warmup_steps"]):
                    prog.step(sseed - 1 - j)
            if prog.kind == "render_grad":
                prog.target = bench.make_target(spec, seed, dev)
            else:
                prog.pixels = bench.pixel_sample(spec, seed)
            _, keep, ok = prog.step(sseed)
            assert ok, "a step's result is not finite"
        got = bench.compare(spec, arrays, seed, [(sseed, keep)], dev)
        if not is_control and prog.kind == "render_grad":
            got.update(_image_gap(spec, prog, arrays, seed, sseed, dev))
        into = control if is_control else sound
        for n, v in got.items():
            into.setdefault(n, []).append(v)
        print(json.dumps({"seed": seed, "control": is_control, **got}), flush=True)
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(dev),
                      "sound_max": {n: max(v) for n, v in sound.items()},
                      "control_min": {n: min(v) for n, v in control.items()},
                      "sound_n": args.seeds, "control_n": args.control_seeds}), flush=True)
    return 0


def _image_gap(spec, prog, arrays, seed, sseed, dev) -> dict:
    """Where the forward image of a gradient step departs from the
    reference's: the program's image by `api.render` at the same sampler
    seed, the reference's by `frame_pixels` over every pixel. The pixels
    off by more than 1e-4, the largest gap, and their share of the loss."""
    import dataclasses

    import torch

    from raybench.lib import bench

    settings = bench.render_settings(spec)
    cfg = dataclasses.replace(prog.cfg, seed=sseed)
    img = prog.api.render(prog.scene, cfg, device=dev, backend=prog.backend).reshape(-1, 3)
    pid = torch.arange(settings["height"] * settings["width"], device=dev)
    rimg = spec.reference.frame_pixels(arrays, settings, pid, sseed, dev)
    gap = (img - rimg).abs().amax(1)
    off = gap > 1e-4
    tgt = bench.make_target(spec, seed, dev).reshape(-1, 3)
    per_px = ((img - tgt) ** 2).sum(1)
    return {"img_px_off": int(off.sum()), "img_max_gap": float(gap.max()),
            "img_off_loss_share": float(per_px[off].sum() / per_px.sum())}


def _flat(arrays):
    return [a for g in ("triangles",) for a in arrays[g].values()]


if __name__ == "__main__":
    sys.exit(main())
