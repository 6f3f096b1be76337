"""Where the complex-omega kernel's spills sit.

    python3 tools_torch/spill_sites.py [--out PATH] [--sass-out PATH]

compiles `eigensolver_tpu_torch/csrc/slab_complex.cu` with the package's
flags (`kernels/_build.py::NVCC_FLAGS`) plus `-lineinfo` to a cubin,
disassembles it with nvdisasm (source lines with their inlining chain) and
counts, for each type's instantiation of the Kelvin-Helmholtz path's
`newton_kernel` (the shear form, the exact exterior), the local loads and stores
(LDL, STL: the spills and the division slow path's stack) by the line of
`newton_kernel`'s own body they were inlined from, which tells the consumer
warp's branch (its `consume` loop, `edge`, `finish`, the Newton update)
from the producers' (`produce`), and by their innermost source line. It
prints the ptxas report of this build beside the package build's, to show
that `-lineinfo` moved no register or spill count. Needs nvcc and nvdisasm
(the CUDA toolkit), no card.

    python3 tools_torch/spill_sites.py --sass PATH

reads a disassembly saved with `--sass-out` instead.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "eigensolver_tpu_torch" / "csrc" / "slab_complex.cu"
# the KH path's instantiation: the shear form with the exact exterior
_KERNEL = re.compile(r"newton_kernelI([fd])Lb1ELb0EE")
_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"\s*(\.L_x_\d+):")
_BRANCH = re.compile(r"BRA\s+`\((\.L_x_\d+)\)")
_SPILL = re.compile(r"(?:@!?U?P\w+\s+)?(LDL|STL)\b")
_SITE = re.compile(r'"([^"]+)", line (\d+)')


def ptxas_newton(log: str) -> dict:
    """Registers and spill bytes of each newton_kernel instantiation in a
    `-Xptxas -v` report (the entry's own lines)."""
    out, key, own = {}, None, False
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            t = _KERNEL.search(m.group(1))
            key, entry = t and t.group(1), m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            # the entry's own, not a function it calls
            own = key is not None and m.group(1) == entry
            continue
        if not own:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(key, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return {("float32" if k == "f" else "float64"): v for k, v in out.items()}


def kernel_branches(src: str) -> tuple:
    """(start, first, else, last) line numbers of newton_kernel's body in
    the source: its prologue runs from `start` to `first`, the consumer
    branch from `first` to `else`, the producers' from `else` to `last`."""
    lines = src.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("newton_kernel(")) + 1
    first = next(i for i in range(start, len(lines))
                 if "if (threadIdx.x < 32)" in lines[i - 1])
    other = next(i for i in range(first, len(lines))
                 if lines[i - 1].strip() == "} else {")
    last = next(i for i in range(other, len(lines))
                if lines[i - 1] == "}")
    return start, first, other, last


def build_sass() -> tuple:
    """The annotated disassembly of a -lineinfo build and its ptxas
    report."""
    sys.path.insert(0, str(ROOT))
    from eigensolver_tpu_torch.kernels import _build
    nvcc = _build._nvcc()
    nvdisasm = str(Path(nvcc).parent / "nvdisasm")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = str(Path(tmp) / "slab_complex.cubin")
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-lineinfo", "-cubin",
                            "-o", cubin, str(SRC)], capture_output=True,
                           text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
        d = subprocess.run([nvdisasm, "-c", "-gi", cubin],
                           capture_output=True, text=True)
        if d.returncode:
            raise RuntimeError(f"nvdisasm failed:\n{d.stderr}")
    return d.stdout, r.stdout + r.stderr


def _sections(sass: str) -> dict:
    """The instructions of each newton_kernel instantiation: (address,
    instruction, the last source annotation before it) in order, and the
    address of each label."""
    out, cur, site = {}, None, None
    pending = []
    for ln in sass.splitlines():
        if ".text." in ln and ln.rstrip().endswith((":", '"ax",@progbits')):
            t = _KERNEL.search(ln)
            cur = t and ("float32" if t.group(1) == "f" else "float64")
            if cur:
                out[cur] = ([], {})
            site, pending = None, []
            continue
        if cur is None:
            continue
        if ln.lstrip().startswith("//##"):
            site = _SITE.findall(ln)
            continue
        m = _LABEL.match(ln)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(ln)
        if m:
            addr = int(m.group(1), 16)
            out[cur][1].update((lb, addr) for lb in pending)
            pending = []
            out[cur][0].append((addr, m.group(2), site))
    return out


def attribute(sass: str, src: str) -> dict:
    """Per instantiation: the LDL and STL instructions in the code (static
    counts, not executions) by the branch of newton_kernel they were
    inlined from (the consumer's, the producers', the prologue before
    them; "unknown" without a line, as in a called routine) and the loop they sit in: the smallest range from a label to
    a branch back to it that holds the instruction, "barrier-free" if
    that range holds no barrier (the consumer's step loop, the producers'
    item and table loops: the code run once a step or an item), "with
    barriers" if it does (a stage or a round loop, outside its inner
    loops), or "outside loops"; and by the line of newton_kernel's body
    they were inlined from."""
    lines = src.splitlines()
    start, first, other, last = kernel_branches(src)
    name = SRC.name

    def branch(ln):
        if ln is None:
            return "unknown"
        if first <= ln < other:
            return "consumer"
        if other <= ln <= last:
            return "producers"
        return "prologue"
    res = {}
    for kern, (insns, labels) in _sections(sass).items():
        loops = []
        for addr, text, _ in insns:
            m = _BRANCH.search(text)
            if m and labels.get(m.group(1), addr + 1) <= addr:
                lo = labels[m.group(1)]
                loops.append((lo, addr, any(
                    "BAR" in t for a, t, _ in insns if lo <= a <= addr)))
        r = {"LDL": 0, "STL": 0, "by_branch_and_loop": collections.Counter(),
             "by_kernel_line": collections.Counter()}
        for addr, text, site in insns:
            m = _SPILL.match(text)
            if not m:
                continue
            op = m.group(1)
            r[op] += 1
            # the outermost frame inside slab_complex.cu's newton_kernel
            outer = [int(n) for f, n in (site or []) if f.endswith(name)
                     and start <= int(n) <= last]
            kl = outer[-1] if outer else None
            held = [lp for lp in loops if lp[0] <= addr <= lp[1]]
            if held:
                inner = min(held, key=lambda lp: lp[1] - lp[0])
                where = "with barriers" if inner[2] else "barrier-free"
            else:
                where = "outside loops"
            r["by_branch_and_loop"][f"{branch(kl)}, {where}, {op}"] += 1
            if kl:
                r["by_kernel_line"][f"{kl} {op}: {lines[kl - 1].strip()}"] += 1
        for key in ("by_branch_and_loop", "by_kernel_line"):
            r[key] = dict(sorted(r[key].items()))
        res[kern] = r
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", help="read this saved disassembly")
    ap.add_argument("--sass-out", help="save the disassembly here")
    ap.add_argument("--out", help="write the report here (JSON)")
    args = ap.parse_args()
    src = SRC.read_text()
    out = {}
    if args.sass:
        sass = Path(args.sass).read_text()
    else:
        sass, log = build_sass()
        out["ptxas_lineinfo"] = ptxas_newton(log)
        sys.path.insert(0, str(ROOT))
        from eigensolver_tpu_torch.kernels import _build
        out["ptxas_package"] = ptxas_newton(
            _build.build().with_suffix(".log").read_text())
        if args.sass_out:
            Path(args.sass_out).write_text(sass)
    out["spills"] = attribute(sass, src)
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
