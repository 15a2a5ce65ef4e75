"""The port's ``spot`` (path names matched over the native walk) against
the JAX package's: stdout and exit code byte for byte on a small tree,
serial (-n 1) and parallel (-n 4) walks, a pattern that does not compile
(255) and the usage line (1)."""

import pytest

from grab_tpu import spot as ref_spot
from grab_tpu_torch import spot as port_spot


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("spot")
    for d in ["a/b/c", "docs", "src/deep", "x y"]:
        (root / d).mkdir(parents=True)
    names = ["a/b/c/secret.doc", "a/b/notes.txt", "docs/secret_plan.doc", "docs/readme.md",
             "src/deep/main.c", "src/util.py", "x y/secret.docx", "top.doc", "empty"]
    for i, name in enumerate(names):
        (root / name).write_bytes(b"x" * i)
    (root / "loop").symlink_to(root)  # physical walk: not followed
    return root


def _run(mod, argv, capsys):
    rc = mod.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("workers", [["-n", "1"], ["-n4"], []], ids=["n1", "n4", "default"])
@pytest.mark.parametrize("pattern", [r"secret.*\.doc", r"\.(c|py)$", "zz-no-such-name", "."])
def test_spot_equal(tree, capsys, workers, pattern):
    argv = workers + [str(tree), pattern]
    want = _run(ref_spot, argv, capsys)
    got = _run(port_spot, argv, capsys)
    assert got == want and got[0] == 0
    if pattern == r"secret.*\.doc":
        assert got[1].count("\n") == 3


@pytest.mark.parametrize("argv", [["DIR", "(unclosed"], ["DIR"], [], ["-n", "2", "DIR", "a", "b"]],
                         ids=["bad-pattern", "one-arg", "none", "three-args"])
def test_spot_errors_equal(tree, capsys, argv):
    argv = [str(tree) if a == "DIR" else a for a in argv]
    want = _run(ref_spot, argv, capsys)
    got = _run(port_spot, argv, capsys)
    assert got[:2] == want[:2]
    if argv[-1:] == ["(unclosed"]:
        assert got[0] == 255 and "pattern compile error" in got[2] and got[1] == ""
    else:
        assert got == (1, "Usage: spot [-n <cores>] <start-dir> <regex>\n", "")
