#!/usr/bin/env python3
"""Readings that the limits of ``bench/limits/<cell>.json`` are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,... --seconds <s> \
        [--control-seeds 3] [--faults 0|1] [--out <file.jsonl>]

For every seed, in one process: the cell's program run (a window of
``--seconds``; a training cell needs none) and the numbers ``correct``
compares.  For the first ``--control-seeds`` seeds also the control — the
reference in float8 put in the program's place — and a planted fault: for
a serving cell the program with one token of each request altered where
it is produced, for a training cell the reference with half of every
batch left out in the program's place (``--faults 0`` leaves out a
serving cell's planted fault).  A serving cell's line also gives the
tokens delivered in 5-second bins from the first submit, to show where
the rate settles.
One JSON line a seed on standard output (and in ``--out``).  The benchmark's
own runs never run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run as bench_run  # noqa: E402


def _serve_altered(serve, cfg, traffic, seed, seconds, device):
    """The program run once more with a fault planted where tokens are
    produced: each request's fifth token replaced by another id."""
    from repro_torch.serving.engine import ServingEngine

    vocab = int(cfg["vocab_size"])
    real = ServingEngine._emit

    def altered(self, req, tok, now):
        if req.n_generated == 4:
            tok = (tok + vocab // 2) % vocab
        return real(self, req, tok, now)

    ServingEngine._emit = altered
    try:
        return serve.run(cfg, traffic, seed, seconds, False, device, time.perf_counter())
    finally:
        ServingEngine._emit = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", type=int, choices=(0, 1), default=1,
                    help="0: no planted fault beside a serving cell's control")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench_run._setup_paths(bench_run.ROOT)
    import torch

    from harness import correct, serve, train
    from harness.records import token_bins

    _, cell, cfg, traffic, limits = bench_run.load_cell(bench_run.ROOT, args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = {"workload": args.workload, "seed": seed}
        control = i < args.control_seeds
        if traffic["kind"] == "train":
            rec = train.run(cfg, traffic, seed, args.seconds, False, device, t)
            line["setup_s"] = rec["setup_s"]
            t_ref = time.perf_counter()
            ref = correct.train_reference(cfg, traffic, seed, device)
            line["reference_s"] = time.perf_counter() - t_ref
            line["program"] = correct.compare_train(rec["check"], ref)
            line["losses"] = {"program": rec["check"]["losses"], "reference": ref["losses"]}
            if control:
                low = correct.train_reference(cfg, traffic, seed, device, "fp8")
                line["control"] = correct.compare_train(low, ref)
                half = correct.train_reference(cfg, traffic, seed, device,
                                               rows=int(traffic["batch"]) // 2)
                line["half_batch"] = correct.compare_train(half, ref)
        else:
            rec = serve.run(cfg, traffic, seed, args.seconds, False, device, t)
            line["setup_s"] = rec["setup_s"]
            prog, low = correct.serve_gaps(rec, cfg, seed, device, "fp8" if control else None)
            line["program"] = correct.gap_numbers(prog)
            # the program's tokens a 5-second bin from the first submit to the window's close
            first = min(r["t_submit"] for r in rec["requests"])
            line["token_bins_5s"] = token_bins(rec, first, rec["t1"], 5.0)
            line["window_opens_s"] = rec["t0"] - first
            line["program_gaps"] = [round(g, 5) for g in sorted(prog, reverse=True)]
            if control:
                line["control"] = correct.gap_numbers(low)
                line["control_gaps"] = [round(g, 5) for g in sorted(low, reverse=True)]
            if control and args.faults:
                rec = _serve_altered(serve, cfg, traffic, seed, args.seconds, device)
                line["altered_token"] = correct.gap_numbers(
                    correct.serve_gaps(rec, cfg, seed, device)[0])
            line["served_tokens"] = sum(len(s["served"]) for s in rec["check_sample"])
            line["sampled_requests"] = len(rec["check_sample"])
        line["limits"] = limits
        line["seconds"] = time.perf_counter() - t
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        del rec
        torch.cuda.empty_cache() if device.type == "cuda" else None
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
