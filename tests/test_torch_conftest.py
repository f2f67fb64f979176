"""The hooks of the root conftest.py: the `slow` marker and the per-test limit.

Each test runs pytest in a subprocess on a small test tree whose conftest
loads the hooks from the root conftest.py.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

TESTS = Path(__file__).resolve().parent
CONFTEST = TESTS.parent / "conftest.py"


def _slow_tests():
    # read, not run: the tuple is a literal
    for node in ast.parse(CONFTEST.read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "SLOW_TESTS":
            return ast.literal_eval(node.value)
    raise AssertionError("no SLOW_TESTS in " + str(CONFTEST))


def _tree(root, files, limit_s=None):
    """A test tree under `root` whose conftest takes the repo's hooks."""
    set_limit = "" if limit_s is None else f"repo.TEST_TIME_LIMIT_S = {limit_s}"
    (root / "pytest.ini").write_text("[pytest]\n")
    (root / "conftest.py").write_text(textwrap.dedent(f"""\
        import importlib.util

        spec = importlib.util.spec_from_file_location("repo_conftest", {str(CONFTEST)!r})
        repo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(repo)
        {set_limit}
        globals().update((k, v) for k, v in vars(repo).items() if k.startswith("pytest_"))
        """))
    for name, text in files.items():
        (root / name).write_text(text)


def _pytest(root, *args, timeout):
    return subprocess.run(
        [sys.executable, "-m", "pytest", str(root), "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", *args],
        cwd=root, capture_output=True, text=True, timeout=timeout,
    )


def test_slow_tests_name_tests_of_the_repo():
    for node_id in _slow_tests():
        file, *names = node_id.split("::")
        scope = ast.parse((TESTS / file).read_text()).body
        for name in names:
            found = [n for n in scope
                     if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                     and n.name == name]
            assert found, node_id
            scope = found[0].body


def test_not_slow_deselects_exactly_the_slow_tests(tmp_path):
    files, kept = {}, set()
    for node_id in _slow_tests():
        file, *names = node_id.split("::")
        body = files.setdefault(file, "def test_kept():\n    pass\n")
        kept.add(f"{file}::test_kept")
        if len(names) == 2:
            body += (f"\nclass {names[0]}:\n    def {names[1]}(self):\n        pass\n"
                     f"\n    def test_kept(self):\n        pass\n")
            kept.add(f"{file}::{names[0]}::test_kept")
        else:
            body += f"\ndef {names[0]}():\n    pass\n"
        files[file] = body
    _tree(tmp_path, files)
    run = _pytest(tmp_path, "--strict-markers", "--collect-only", "-m", "not slow",
                  timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    selected = {line for line in run.stdout.splitlines() if "::" in line}
    assert selected == kept, run.stdout
    assert f"({len(_slow_tests())} deselected)" in run.stdout, run.stdout


def test_a_test_past_the_limit_fails_alone_with_its_stack(tmp_path):
    _tree(tmp_path, {"test_limit.py": textwrap.dedent("""\
        import time


        def test_sleeps_past_the_limit():
            time.sleep(120)


        def test_after_it():
            pass
        """)}, limit_s=2)
    run = _pytest(tmp_path, "-p", "xdist", "-n", "1", "--dist", "loadfile",
                  timeout=120)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "Timeout (0:00:02)!" in out, out
    assert 'test_limit.py", line 5 in test_sleeps_past_the_limit' in out, out
    assert "crashed while running 'test_limit.py::test_sleeps_past_the_limit'" in out, out
    assert "1 failed, 1 passed" in out, out


def test_the_hooks_are_loaded_in_this_run(request):
    markers = [line.partition(":")[0] for line in request.config.getini("markers")]
    assert "slow" in markers, markers
    assert request.config.pluginmanager.has_plugin(str(CONFTEST)), CONFTEST
