"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard
output, and each number compared for ``correct`` beside its limit as the
last lines of standard error. Exits non-zero, printing no result, when
the port is not in the checkout, when there is no CUDA device or fewer
than the cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "chowdsp_fft_tpu")


def since_process_start() -> float:
    """Seconds from the process's start to ``T_START`` (10 ms ticks)."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - started - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    t_start = T_START - since_process_start()
    log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
    log(f"set-up: {T_START - t_start:.3f} s to the start of portbench.run")

    # Every cache stays at a fixed path inside the checkout.
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    try:
        import chowdsp_fft_tpu_torch
    except ImportError as e:
        print(f"portbench: the port is not in this checkout ({e})", file=sys.stderr)
        return 3
    if not pathlib.Path(chowdsp_fft_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"portbench: chowdsp_fft_tpu_torch loads from {chowdsp_fft_tpu_torch.__file__}, "
              f"outside the checkout {ROOT}", file=sys.stderr)
        return 3
    log(f"set-up: {time.perf_counter() - t_start:.3f} s to the port's import, torch's with it")
    import torch

    from portbench import harness

    cell = harness.find(harness.load_benchmark(ROOT)["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.zeros(1, device="cuda")
    log(f"set-up: {time.perf_counter() - t_start:.3f} s to the CUDA context and a first allocation")
    result, check_lines = harness.run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                                           trace_on=bool(args.trace), t_start=t_start, log=log)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 4
    for line in check_lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
