"""Print what the harness finds by name: ``read`` of a metric (on
made-up readings of 12 calls) and the port's kernel names.

    python -m portbench.tests.find_probe METRIC
"""

import json
import sys

from portbench import harness


def main():
    readings = harness.Readings(calls=12, window_s=1.0, busy_s=0.5, device=[], port_kernels=frozenset(),
                                enqueue_s=[], work={})
    print(json.dumps({"reader": harness.metric_reader(sys.argv[1])(readings),
                      "kernels": sorted(harness.port_kernel_names())}))


if __name__ == "__main__":
    main()
