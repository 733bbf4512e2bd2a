#!/usr/bin/env python3
"""Whether torch.profiler in this process still records every launch of a
window after other processes have run on the same card, and after an NCCL
group in this process. Run from the root of a checkout, on a machine with
a CUDA GPU and nvcc:

    python3 tools/profiler_after_ranks.py

Profiles three windows of 50 calls each of the transposed row kernel (#1)
and of cuFFT at [1, 1024, 1024] and prints the launches recorded and the
device ms a call: in a fresh process; with an NCCL group at world size 1
open; after it is destroyed; after chip_smoke's path (li) ran in two rank
processes sharing the card under gloo; and 5 s later. chip_smoke.py times
each kernel before any other process runs on the card for this reason.
"""

import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from tpu_ocean_torch import _build  # noqa: E402
from tpu_ocean_torch.fft import planes  # noqa: E402


def report(tag, cases):
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        windows = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0]
            windows.append((sum(e.count for e in kernels),
                            round(sum(e.self_device_time_total
                                      for e in kernels) / 1e3 / 50, 4)))
        print(f"{tag}: {name}: (launches recorded of 50, ms a call) "
              f"{windows}", flush=True)


def main():
    _build.load()
    re = torch.randn(1, 1024, 1024, device="cuda")
    im = torch.randn_like(re)
    z = torch.complex(re, im)
    cases = {"#1 [1,1024,1024]": lambda: planes.fft1d_transposed(re, im, True),
             "cuFFT [1,1024,1024]": lambda: torch.fft.ifft(z, dim=-1,
                                                           norm="forward")}
    report("fresh process", cases)
    dist.init_process_group("nccl",
                            init_method=f"file://{tempfile.mkdtemp()}/r",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    report("an NCCL group open", cases)
    dist.destroy_process_group()
    report("after destroying it", cases)
    work = Path(tempfile.mkdtemp(dir=chip_smoke.HERE / "build"))
    chip_smoke.run_sharded_ranks([chip_smoke.SHARDED_PATHS[1]], 2, work)
    report("after two rank processes ran on the card", cases)
    time.sleep(5)
    report("5 s later", cases)


if __name__ == "__main__":
    main()
