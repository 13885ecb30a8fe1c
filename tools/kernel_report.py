"""Reports shared by the kernel A/B scripts in `tools/`: what ptxas says of
a kernel, its SASS size, the shared memory and resident blocks its library
reports, its device time by the profiler, and a fresh build of one
library.

The scripts put the checkout under test (ROOT) on PYTHONPATH; this module
takes `chip_smoke.py` and `ops/_build.py` from there, so it reports on
ROOT's kernels with this checkout's code.
"""

import ctypes
import re
import subprocess
import time
from pathlib import Path

import torch

import chip_smoke as cs
from featurematching_tpu_torch.ops import _build

REPS = 10


def _entry(mangled: str, names: str):
    """`name<a, b>` of a mangled kernel name whose bare name is one of
    `names` (a regex alternation), with its integer and bool template arguments;
    None where it is none of them."""
    m = re.search(rf"({names})(?:I((?:L[ib]-?\d+E)+))?", mangled)
    if not m:
        return None
    args = re.findall(r"L[ib](-?\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def ptxas_report(log: str, kernels=("apply_kernel",), threads: int = 0) -> None:
    """Each of `kernels`' registers, spills and static shared memory from
    ptxas (at each template instantiation), with `threads` a block the
    blocks an SM its registers allow, and ptxas' notes on wgmma."""
    names = "|".join(kernels)
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        name = m and _entry(m.group(1), names)
        if not name:
            continue
        info = " ".join(x.replace("ptxas info    :", "").strip() for x in lines[i + 1:i + 4]
                        if "Compiling" not in x and "Function properties" not in x)
        regs = re.search(r"Used (\d+) registers", info)
        if threads and regs:
            per_thread = -(-int(regs.group(1)) // 8) * 8  # allocated 8 at a time
            info += f" -> {65536 // (per_thread * threads)} blocks an SM by registers"
        print(f"  {name}: {info}")
    for line in lines:
        if "gmma" in line.lower() or "warning" in line.lower():
            print(f"  ptxas: {line.strip()}")


def code_report(kernel: str = "apply_kernel", lib: str = "coarse_transformer") -> None:
    """The kernel's SASS instructions at each template instantiation, from
    cuobjdump on ROOT's built library `lib`."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path(lib))],
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = _entry(line.split("Function : ")[1].strip(), kernel)
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] = counts.get(name, 0) + 1
    for n, k in sorted(counts.items()):
        print(f"  {n}: {k} SASS instructions ({16 * k} bytes)")


def occupancy_report(lib: str, exports: dict, widths) -> dict:
    """Each kernel's dynamic shared memory and resident blocks an SM at each
    (C, D) of `widths`, from ROOT's library `lib`: `exports` maps a kernel's
    label to the C entry that fills {bytes, blocks} for it (a kernel whose
    entry the library lacks is reported so). Returns {(label, C, D): (bytes,
    blocks)}."""
    so = _build._load(lib)
    out = {}
    for label, export in exports.items():
        if not hasattr(so, export):
            print(f"  occupancy of {label}: not exported by this tree's library")
            continue
        fn = getattr(so, export)
        fn.argtypes = [_build.INT, _build.INT, ctypes.POINTER(ctypes.c_int)]
        fn.restype = _build.INT
        for c, d in widths:
            info = (ctypes.c_int * 2)()
            err = fn(c, d, info)
            if err:
                raise RuntimeError(f"{export}({c}, {d}): CUDA error {err}")
            print(f"  C={c}, D={d}: {label} {info[0]} bytes of dynamic shared memory, {info[1]} "
                  "blocks an SM")
            out[(label, c, d)] = (info[0], info[1])
    return out


def by_kernel(fn, kernels=("stats_kernel", "merge_kernel", "apply_kernel"),
              tries: int = 3, reps: int = REPS) -> dict:
    """Device ms of each kernel of one fn() call, by kernel name, from the
    profiler over `reps` calls; fn() launches each of `kernels` once, and a
    profile that saw another count lost events and is taken again, up to
    `tries` times, before this raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split, seen = {}, {}
        for e in prof.key_averages():
            if not cs.is_kernel(e):
                continue
            bare = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            k = re.split(r"[<(]", bare)[0].split("::")[-1]
            split[k] = split.get(k, 0.0) + e.device_time_total / 1e3 / reps
            seen[k] = seen.get(k, 0) + e.count
        if all(seen.get(k) == reps for k in kernels):
            return split
        print(f"  profiler: launches seen {seen}, made {reps} of each of {kernels}: profiling "
              f"again", flush=True)
    raise AssertionError(f"the profiler lost kernel events {tries} times")


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def rebuild(*libs: str) -> str:
    """Build ROOT's libraries `libs` anew (so that ptxas reports on them),
    print the build's time and the card; return ptxas' log."""
    libs = libs or ("coarse_transformer",)
    t = time.time()
    for lib in libs:
        _build._lib_path(lib).unlink(missing_ok=True)
    logs = _build.build(libs, ptxas_verbose=True)
    print(f"[{_build.CSRC.parent.parent}] build {time.time() - t:.1f} s; card {card()}",
          flush=True)
    return "\n".join(logs.get(lib, "") for lib in libs)
