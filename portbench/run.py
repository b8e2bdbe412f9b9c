"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``tedm_tpu_torch/``). The
cell's files are found by its name (``harness.py``). With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of a few units after
the measured window, and a breakdown of the device's time. Every run checks
what the window produced against the plain reference (``correct``).

It exits with 2, printing no result, without as many CUDA cards as the
cell asks for; with 3 if JAX or the JAX package was loaded; with 4 if a
traced run's profiler saw no device work.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device: str = "cuda") -> int:
    """One run; ``device="cpu"`` (the tests, at sizes they patch in) skips
    the look for cards."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # kernel caches at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "portbench", "_cache", sub)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    cell = harness.cell(args.workload)
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    out = harness.driver(cell["mix"]["driver"]).run(cell, args.seed, args.seconds, bool(args.trace), T0,
                                                    device=device)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3

    end_to_end, per_layer = harness.cell_metrics(args.workload)
    metrics = {}
    if args.trace:
        for m in per_layer:
            value = harness.metric_reader(m["name"]).read(out["view"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    correct, compared = harness.judge(out["numbers"], cell["limits"])
    card = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": card}
    tr = out["view"]["trace"]
    if args.trace and not tr:
        print("portbench: the profiler saw no device work in the traced units", file=sys.stderr)
        return 4
    if args.trace:
        card.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    harness.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
