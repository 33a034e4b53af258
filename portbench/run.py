"""One run of one benchmark cell of clair_tpu_torch.

    python3 portbench/run.py --workload train-f32 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout, on a machine with the cards the cell asks
for. The run makes its inputs and weights from ``--seed``, sets up and warms
up (``setup_s``: process start to the first timed step), measures for
``--seconds``, checks what its first steps computed against the plain
reference (portbench/reference/), and prints as its last line one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics) and
``device``; then ``breakdown`` (``--trace 1``) and ``compared``, each number
compared with its limit, which are also the last lines on standard error.

It exits non-zero and prints no result without a CUDA device, with fewer
cards than the cell asks for, outside a checkout of the repository, and
when the JAX package or JAX is loaded once the window has closed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this directory, heads the import path
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = REPO


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    spec = harness.load_spec()
    chips = harness.workload(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    result, lines = harness.run(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                                device, STARTED,
                                log=lambda line: print(line, file=sys.stderr))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: these modules are loaded and must not be: {loaded}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
