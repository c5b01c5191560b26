#!/usr/bin/env python3
"""The float32 block kernels' output digests that
tests/test_torch_cuda.py::test_float32_kernels_byte_equal_to_parent holds
(F32_DIGESTS): sha256 of rows 1-5's float32 outputs on the card tests'
stored inputs, from the package under ROOT (default: this checkout), on
one CUDA card. To take them from an earlier commit, unpack it and point
ROOT at it; the package there builds its own kernels:

    git archive <commit> | tar -x -C /path/to/old
    python3 scripts/float32_digests.py /path/to/old
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0] if argv else HERE)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("float32_digests: no CUDA device", file=sys.stderr)
        return 2
    # the inputs and the digest come from this checkout's card tests, the
    # kernels from ROOT's package
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(HERE, "tests", "test_torch_cuda.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    print("kernels from", os.path.dirname(tests.fused_mu.__file__))
    print(json.dumps(tests._float32_digests(torch.device("cuda")),
                     sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
