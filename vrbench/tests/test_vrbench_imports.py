"""What the harness and the reference load, compared by whole top-level
names."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from vrbench import spec

ROOT = str(spec.ROOT)


def loaded_after(code: str) -> set[str]:
    """Top-level names of ``sys.modules`` in a fresh interpreter after
    ``code``."""
    prog = (f"import sys; sys.path.insert(0, {ROOT!r})\n{code}\n"
            "import json; print(json.dumps(sorted({n.split('.')[0] "
            "for n in list(sys.modules)})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def harness_modules() -> list[str]:
    here = spec.HERE
    mods = ["vrbench.run", "vrbench.control", "vrbench.check", "vrbench.gen",
            "vrbench.loop", "vrbench.spec", "vrbench.trace", "vrbench.stats",
            "vrbench.roofline"]
    for package in ("entries", "metrics", "costs", "reference", "frames",
                    "surfaces"):
        mods += [f"vrbench.{package}.{f[:-3]}"
                 for f in sorted(os.listdir(here / package))
                 if f.endswith(".py") and f != "__init__.py"]
    return mods


def test_harness_loads_no_jax_by_whole_name():
    names = loaded_after("\n".join(f"import {m}" for m in harness_modules()))
    from vrbench.run import FORBIDDEN
    assert not names & FORBIDDEN
    # the port itself is loaded, and its name begins with the JAX package's
    assert "videorenderer_tpu_torch" in names


def test_reference_loads_nothing_of_the_program():
    mods = [m for m in harness_modules()
            if m.startswith("vrbench.reference.")]
    assert "vrbench.reference.oracle" in mods
    names = loaded_after("\n".join(f"import {m}" for m in mods))
    from vrbench.run import FORBIDDEN
    assert not names & (FORBIDDEN | {"videorenderer_tpu_torch"})


@pytest.mark.parametrize("loaded, found", [
    (["videorenderer_tpu_torch", "videorenderer_tpu_torch.ops"], []),
    (["jaxtyping", "jax_foo", "flaxen"], []),
    (["videorenderer_tpu", "os"], ["videorenderer_tpu"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
])
def test_forbidden_modules_compares_whole_names(monkeypatch, loaded, found):
    import vrbench.run as run
    monkeypatch.setattr(run.sys, "modules",
                        {n: object() for n in ["sys", *loaded]})
    assert run.forbidden_modules() == found


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the harness would run")
    out = subprocess.run([sys.executable, "vrbench/run.py", "--workload",
                          "hdr10_1080.b16", "--seed", str(2 ** 31 + 5),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr
