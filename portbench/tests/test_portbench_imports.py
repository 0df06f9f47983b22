"""No module of JAX, Flax or the JAX package ``repro`` is loaded by a
run; names are compared whole (``repro_torch`` is not ``repro``)."""
import subprocess
import sys
import textwrap

import pbtest_util as U
from pb import imports


def test_names_compared_whole():
    mods = ["repro_torch", "repro_torch.core", "repro", "repro.core",
            "jaxlib", "jax_like", "flax.linen", "reprox"]
    assert imports.forbidden_loaded(mods) == ["flax.linen", "jaxlib",
                                              "repro", "repro.core"]


def test_a_run_loads_none(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(U.BENCH / 'tests')!r})
        import pbtest_util as U
        from pathlib import Path
        root = U.tiny_root(Path({str(tmp_path)!r}))
        assert U.run(root, "tiny.reach", traced=True)["correct"]
        from pb import imports
        print(imports.forbidden_loaded())
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=U.REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
