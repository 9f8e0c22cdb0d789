"""Pick the per-layer weight ranges of ``chip_smoke.LIVE_RANGES`` for a
full-width ResNet trunk, on the CPU.

    python3 tools/live_ranges.py --depth 50 [--tail-from T]

Runs ``serve/model.py::resnet_trunk_graph(depth)`` under
``ServedModel.compile`` on ``"torch-cpu"`` (bit-equal to the JAX package's
numpy backend) on images 0-1 of ``random_images(8, seed=0)``, segment by
segment in order, the output of the segments already fixed kept, so that a
trial reruns one segment. Each layer's weights are drawn as
``chip_smoke.live_weights`` draws them (``live_tensor``), r from ``STEPS``:
the largest r that leaves every tensor its segment stores at most ``CAP``
at the int8 limits (one r for the layers of a fused chain); the fc at
r = 1. The segments that feed the unshifted fc are then cut, from the last
stage on and then from one segment earlier at a time: their outputs' root
mean square held to each bound of ``TAIL_RMS`` in turn, until every one of
them and the fc lie inside ``chip_smoke``'s bands (``LIVE_NONZERO``,
``LIVE_SATURATED``); ``--tail-from`` names the first segment cut (by the
tensor it stores) and skips that search. Prints each segment's choice and
shares, then the table as Python; exits nonzero if a segment is outside
the bands. The tables of ``LIVE_RANGES``: ``--depth 34`` (~30 s on 8
cores), ``--depth 50 --tail-from resnet50.s2b0.3`` (the search's own
answer, which took 22 minutes) and ``--depth 101 --tail-from
resnet101.s2b0.3`` (~3 minutes).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 127)
CAP = 0.10         # a segment's greatest share at the int8 limits


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TAIL_RMS = (32, 24, 16, 12, 8, 6, 4, 3, 2, 1.5, 1)


def run(cs, be, model, segments, state, ranges, rms) -> list:
    """Fix the r of each weighted layer of ``segments`` in order (the fc at
    1), their outputs written into ``state``: the largest r of ``STEPS``
    whose stored tensors are at most ``CAP`` at the int8 limits and, with
    ``rms``, of at most that root mean square. Returns (tensor, r, nonzero
    share, saturated share, outside the bands) rows."""
    import torch
    rows = []
    n = next(iter(state.values())).shape[0]
    for seg in segments:
        layers = sorted({t.rsplit(".", 1)[0] for t in seg.reads
                         if t.endswith(".wgt")})
        batched = {}
        for t in set(seg.reads) | set(seg.writes):
            if t in model.weights:
                continue
            if t not in state:
                state[t] = torch.zeros((n,) + model.shapes[t],
                                       dtype=torch.int8)
            batched[t] = state[t]

        def trial(r):
            shared = {t: torch.tensor(cs.live_tensor(
                t, model.weights[t], r or 1)) for t in seg.reads
                if t in model.weights}
            outs = be.run_batched(seg.program, model.hw, shared=shared,
                                  batched=batched)
            return outs, {t: cs.shares(v.numpy()) for t, v in outs.items()}

        def fits(got):
            outs, seen = got
            if max(s for _, s in seen.values()) > CAP:
                return False
            return rms is None or all(
                float(v.float().pow(2).mean().sqrt()) <= rms
                for v in outs.values())
        if not layers:
            r, (outs, seen) = None, trial(None)
        elif layers[0].endswith(".fc"):
            r, (outs, seen) = 1, trial(1)
        else:                   # a fused chain: one r for its layers
            lo, hi = 0, len(STEPS) - 1     # the largest step that fits
            best = None
            while lo <= hi:
                mid = (lo + hi) // 2
                got = trial(STEPS[mid])
                if fits(got):
                    best, lo = (STEPS[mid], got), mid + 1
                else:
                    hi = mid - 1
            r, (outs, seen) = best if best else (1, trial(1))
        ranges.update((k, r) for k in layers)
        state.update(outs)
        rows += [(t, r, nz, sat, nz < cs.LIVE_NONZERO
                  or sat > cs.LIVE_SATURATED)
                 for t, (nz, sat) in seen.items()]
    return rows


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, required=True)
    ap.add_argument("--tail-from", default=None,
                    help="the tensor the first cut segment stores (default: "
                         "search back from the last stage)")
    args = ap.parse_args(argv[1:])
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.serve.model import ServedModel, resnet_trunk_graph
    from repro_torch.vta.backend import get_backend
    from repro_torch.vta.isa import DEFAULT_VTA
    cs = _chip_smoke()
    name = f"resnet{args.depth}-trunk"
    model = ServedModel.compile(name, resnet_trunk_graph(args.depth),
                                DEFAULT_VTA)
    be = get_backend("torch-cpu")
    imgs = model.random_images(8, seed=0)[:2]
    tail = f"resnet{args.depth}.s3"
    first_tail = next(i for i, seg in enumerate(model.segments)
                      if any(t.startswith(tail) for t in seg.writes))
    starts = range(first_tail, 0, -1)
    if args.tail_from:
        starts = [next(i for i, seg in enumerate(model.segments)
                       if seg.writes[0] == args.tail_from)]
    t0 = time.perf_counter()
    state = {model.input_name: torch.tensor(imgs)}
    ranges: dict = {}
    head, saved = [], []
    for seg in model.segments[:max(starts)]:
        saved.append((dict(state), dict(ranges), len(head)))
        head += run(cs, be, model, [seg], state, ranges, None)
    saved.append((dict(state), dict(ranges), len(head)))
    # the segments that feed the fc cut, from the last stage back one
    # segment at a time, each time under each bound of TAIL_RMS in turn
    done = False
    for first in starts:
        for rms in TAIL_RMS:
            tail_state, tail_ranges, k = (dict(x) if isinstance(x, dict)
                                          else x for x in saved[first])
            rows = run(cs, be, model, model.segments[first:], tail_state,
                       tail_ranges, rms)
            if not any(out for *_, out in rows):
                done = True
                break
        if done:
            break
    rows = head[:k] + rows
    bad = 0
    for t, r, nz, sat, out in rows:
        bad += out
        print(f"{t:28s} r {r!s:>4}  nonzero {nz:.4f}  saturated "
              f"{sat:.4f}{'  OUTSIDE' if out else ''}", flush=True)
    ranges = tail_ranges
    print(f"# {name}: {len(ranges)} layers, from "
          f"{model.segments[first].writes[0]} on at rms <= {rms}, "
          f"{bad} segment outputs outside the bands, "
          f"{time.perf_counter() - t0:.1f} s")
    prefix = f"resnet{args.depth}."
    items = [(k[len(prefix):], r) for k, r in ranges.items()]
    print("{" + ", ".join(f'"{k}": {r}' for k, r in items) + "}")
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
