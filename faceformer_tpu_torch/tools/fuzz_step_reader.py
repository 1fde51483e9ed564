"""Fuzz the port's Part 21 STEP reader (tools/step21.py through
tools/step_native.py::load_solid; the PyTorch port's counterpart of the
root tools/fuzz_step_reader.py).

The reader parses untrusted files with a recursive-descent grammar and an
entity-graph resolver, so this command feeds it mutated writer output and
hostile hand-built payloads and holds it to the reference's robustness
contract (the 5 s watchdog around OCC's reader, read_step_file.py:9):

  * bounded time: every input finishes inside --watchdog seconds;
  * bounded memory: peak RSS growth over the run stays under --max-rss-mb;
  * clean failure: the only exceptions that may escape ``load_solid`` are
    ``UnsupportedStep`` and ``StepSyntaxError``, or the loader's own
    ``AssertionError("no shape to transfer")`` for a file without a shape.

Seeds come from the corpus writer families through
``tools/gen_step_solids.py`` (``random_composite`` every third seed,
``random_step_solid`` otherwise; no corpus on disk needed). Mutations:
byte level (flip, delete, insert ranges), references rewired (dangling,
retyped, self-cyclic), numbers replaced (1e999, -0.0, 1e-300, 0), entity
rows dropped or duplicated, truncation mid-entity; then the structural
payloads of ``pathological`` (deep nesting, a long reference cycle, a
giant flat aggregate, no DATA section, null and star references).

    python -m faceformer_tpu_torch.tools.fuzz_step_reader --num 300 --seed 0

Prints "<n> inputs: <status>=<count>, ...", the peak RSS, and a
"VIOLATION <case>: <status>: <detail>" line for each of the first 20
inputs that broke the contract; exits 1 on a violation or on memory growth
past --max-rss-mb, 0 otherwise. Host code: no torch.
"""

from __future__ import annotations

import argparse
import os
import random
import re
import resource
import signal
import sys
import tempfile
from typing import Iterator, List, Tuple

import numpy as np

from faceformer_tpu_torch.tools import step_native
from faceformer_tpu_torch.tools.gen_step_solids import random_composite, random_step_solid
from faceformer_tpu_torch.tools.step21 import StepSyntaxError, UnsupportedStep

_REF = re.compile(r"#(\d+)")
_NUM = re.compile(r"[+-]?\d+\.\d*(?:[eE][+-]?\d+)?")
_ROW = re.compile(r"^#\d+ = .*;$", re.MULTILINE)

_BAD_NUMBERS = ["1e999", "-1e999", "-0.0", "1e-300", "0", "99999999999999999999"]

# what load_solid may return or raise without breaking the contract
CLEAN = ("ok", "none", "clean")


class _Timeout(Exception):
    pass


def _alarm(_sig, _frm):
    raise _Timeout()


def make_seeds(rng_seed: int, count: int) -> List[str]:
    """STEP texts covering the writer families (composites included)."""
    rng = np.random.default_rng(rng_seed)
    return [(random_composite if k % 3 == 0 else random_step_solid)(rng, f"fuzz{k:03d}")
            for k in range(count)]


def mutate(text: str, rng: random.Random) -> str:
    kind = rng.random()
    if kind < 0.30:  # byte level
        buf = bytearray(text.encode())
        for _ in range(rng.randint(1, 25)):
            if not buf:
                break
            i = rng.randrange(len(buf))
            op = rng.random()
            if op < 0.4:
                buf[i] = rng.randrange(256)
            elif op < 0.7:
                del buf[i:i + rng.randint(1, 40)]
            else:
                buf[i:i] = bytes(rng.randrange(256) for _ in range(rng.randint(1, 20)))
        return buf.decode(errors="replace")
    if kind < 0.55:  # rewire references
        ids = [int(m) for m in _REF.findall(text)]
        if not ids:
            return text
        out = text
        for _ in range(rng.randint(1, 6)):
            src = rng.choice(ids)
            dst = rng.choice([rng.choice(ids), src, max(ids) + rng.randint(1, 999)])
            # one occurrence after a '(' or ',': rewire an argument, not an entity's id
            pat = re.compile(r"(\(|,\s*)#%d\b" % src)
            out = pat.sub(lambda m: m.group(1) + f"#{dst}", out, count=1)
        return out
    if kind < 0.75:  # numbers
        return _NUM.sub(lambda m: rng.choice(_BAD_NUMBERS) if rng.random() < 0.2
                        else m.group(0), text)
    if kind < 0.9:  # drop or duplicate a row
        rows = _ROW.findall(text)
        if not rows:
            return text
        row = rng.choice(rows)
        if rng.random() < 0.5:
            return text.replace(row + "\n", "", 1)
        return text.replace(row, row + "\n" + row, 1)
    return text[:rng.randrange(max(len(text) // 4, 1), len(text))]  # truncate


def pathological() -> Iterator[Tuple[str, str]]:
    yield "empty", ""
    yield "no_data", "ISO-10303-21;\nHEADER;\nENDSEC;\nEND-ISO-10303-21;"
    yield "unterminated", "DATA;\n#1 = FOO((1,2,"
    yield "deep_nesting", "DATA;\n#1 = FOO(" + "(" * 5000 + "1" + ")" * 5000 + ");\nENDSEC;"
    yield "giant_flat", ("DATA;\n#1 = CARTESIAN_POINT(''" + ",(0.,1.,2.)" * 200000
                         + ");\nENDSEC;")
    cyc = ["DATA;"]
    for i in range(1, 2001):
        cyc.append(f"#{i} = EDGE_LOOP('',(#{i % 2000 + 1}));")
    cyc.append("#3000 = MANIFOLD_SOLID_BREP('x',#1);")
    cyc.append("ENDSEC;")
    yield "long_cycle", "\n".join(cyc)
    yield "null_refs", ("DATA;\n#1 = MANIFOLD_SOLID_BREP('x',$);\n"
                        "#2 = ADVANCED_FACE('',($),$,.T.);\nENDSEC;")
    yield "star_everywhere", "DATA;\n#1 = MANIFOLD_SOLID_BREP(*,*);\nENDSEC;"


def run_one(path: str, watchdog: int) -> Tuple[str, str]:
    """-> (status, detail); status is one of ``CLEAN``, ``TIMEOUT`` or the
    name of the exception that escaped."""
    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(watchdog)
    try:
        # mutated numbers make inf and nan along the way: the contract is
        # about exceptions and bounds, not floating-point warnings
        with np.errstate(all="ignore"):
            solid, n = step_native.load_solid(path)
        return ("ok" if solid is not None else "none"), f"{n} shapes"
    except (UnsupportedStep, StepSyntaxError) as exc:
        return "clean", f"{type(exc).__name__}: {str(exc)[:60]}"
    except AssertionError as exc:
        if "no shape to transfer" in str(exc):
            return "clean", "no shape to transfer"
        return "AssertionError", str(exc)[:120]
    except _Timeout:
        return "TIMEOUT", f"exceeded {watchdog}s"
    except Exception as exc:  # noqa: BLE001 -- what escaped is the finding
        return type(exc).__name__, str(exc)[:120]
    finally:
        signal.alarm(0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num", type=int, default=300, help="mutated inputs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--seeds", type=int, default=24,
                        help="writer-family seed texts the mutations draw from")
    parser.add_argument("--watchdog", type=int, default=5, help="seconds an input may take")
    parser.add_argument("--max-rss-mb", type=int, default=2048,
                        help="peak RSS growth allowed over the run")
    parser.add_argument("--save-failures", default=None,
                        help="directory to write the inputs that broke the contract into")
    args = parser.parse_args(argv)

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    seeds = make_seeds(args.seed, args.seeds)
    rng = random.Random(args.seed)
    cases = [(f"path_{name}", text) for name, text in pathological()]
    cases += [(f"mut_{k:04d}", mutate(rng.choice(seeds), rng)) for k in range(args.num)]

    tally, violations = {}, []
    with tempfile.TemporaryDirectory(prefix="fuzz_step_") as workdir:
        for name, text in cases:
            path = os.path.join(workdir, name + ".step")
            with open(path, "w") as f:
                f.write(text)
            status, detail = run_one(path, args.watchdog)
            tally[status] = tally.get(status, 0) + 1
            if status not in CLEAN:
                violations.append((name, status, detail))
                if args.save_failures:
                    os.makedirs(args.save_failures, exist_ok=True)
                    with open(os.path.join(args.save_failures, name + ".step"), "w") as f:
                        f.write(text)
            os.remove(path)

    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    print(f"{len(cases)} inputs: " + ", ".join(f"{k}={v}" for k, v in sorted(tally.items())))
    print(f"peak RSS {rss1:.0f} MB (start {rss0:.0f} MB)")
    for name, status, detail in violations[:20]:
        print(f"  VIOLATION {name}: {status}: {detail}")
    if rss1 - rss0 > args.max_rss_mb:
        print(f"MEMORY VIOLATION: grew {rss1 - rss0:.0f} MB > {args.max_rss_mb} MB")
        return 1
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
