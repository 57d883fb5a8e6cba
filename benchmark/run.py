"""The benchmark of ed3dgs_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (beside BENCHMARK.json and ed3dgs_torch/).
It makes the cell's inputs from the seed, sets the program up, measures
for --seconds, and with --trace 1 profiles a short window after it; then it
compares what the program produced with the plain reference
(benchmark/reference/) and prints one JSON line last: correct, attempted,
failed, the metrics (end-to-end with --trace 0, per layer with --trace 1),
the device, and the numbers compared beside their limits. `--control`
puts the reference one precision step down in the program's place (the
control of the comparison; no window).

Without a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "ed3dgs_tpu")


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main():
    ap = argparse.ArgumentParser(description="ed3dgs_torch benchmark: one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="read the reference one precision step down instead of the program")
    args = ap.parse_args()

    root = os.getcwd()
    if not (os.path.isfile(os.path.join(root, "BENCHMARK.json"))
            and os.path.isdir(os.path.join(root, "ed3dgs_torch"))):
        fail("run from the root of a checkout: BENCHMARK.json and ed3dgs_torch/ must be there")
    # every build and kernel cache of the program inside the checkout
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, ".bench_cache", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, ".bench_cache", "triton")
    sys.path[:0] = [HERE, root]
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from harness import cell

    spec = cell.cell_spec(bench, args.workload)
    import torch
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); torch.cuda.is_available()="
             f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}")
    out = cell.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                        t_start=T_START, spec=spec, control=args.control)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        fail(f"the process loaded {found}: the benchmark measures ed3dgs_torch alone", 3)
    result = out["result"]
    for k, v in out["notes"].items():
        print(f"note {k[1:]}: {v}", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
