"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: ``repro_torch`` is not ``repro``)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    """Top-level names of every absolute import, and a marker for a
    relative import that leaves the file's own package."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                out.add(node.module.split(".")[0])
            elif node.level > 1:
                out.add("<parent package>")
    return out


def test_walk_sees_every_file():
    assert HERE / "run.py" in FILES
    assert HERE / "reference" / "automaton.py" in FILES
    assert HERE / "metrics" / "mfu_pct.route.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert not top_level_imports(path) & {"repro_torch", "repro", "jax",
                                          "torch", "<parent package>",
                                          "portbench"}


@pytest.mark.parametrize("path", sorted((HERE / "languages").rglob("*.py")),
                         ids=lambda p: p.name)
def test_languages_import_nothing_of_the_program(path):
    """A language module reaches the harness's generators and reference
    (``..``), never the program."""
    assert not top_level_imports(path) & {"repro_torch", "repro", "jax",
                                          "torch"}


def test_names_compare_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nimport jaxlib.xla\n"
                 "from repro.core import x\nfrom ..gen import y\n")
    assert top_level_imports(f) == {"repro_torch", "jaxlib", "repro",
                                    "<parent package>"}
    f.write_text("import repro_torch\nfrom .wire import decode\n")
    assert not top_level_imports(f) & {"jax", "jaxlib", "flax", "repro"}
