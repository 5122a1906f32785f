#!/usr/bin/env python3
"""Static SASS instruction counts of the flash-attention kernels.

    python3 tools/sass_counts.py

Builds (or reuses) the library of horovod_tpu_torch/csrc/flash_attention.cu,
disassembles it with the CUDA toolkit's cuobjdump, and counts, for each
kernel instance, its instructions by opcode (the part before the first
dot: HGMMA, MUFU, FFMA, ...) and in all.  These are counts of the code,
not of executed instructions: a loop body counts once.  Prints one JSON
object.  Needs the CUDA toolkit (nvcc and cuobjdump), not a GPU.
"""

import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNEL = re.compile(r"Function : \S*?(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                    r"ILi(\d+)ELi(\d+)")
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def counts(sass: str) -> dict:
    out, name = {}, None
    for line in sass.splitlines():
        m = KERNEL.search(line)
        if m:
            name = "%s<%s,%s>" % m.groups()
            out[name] = collections.Counter()
            continue
        m = INSTR.search(line)
        if name and m:
            out[name][m.group(1)] += 1
    return {k: {"total": sum(c.values()), **dict(c.most_common())}
            for k, c in out.items()}


def main() -> int:
    from horovod_tpu_torch.ops import _build
    lib = _build.build("flash_attention")
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    print(json.dumps(counts(sass)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
