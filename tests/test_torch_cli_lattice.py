"""The port's 11 lattice verbs against the JAX package's on the CPU: each
verb of both packages' ``cli.main`` on the same npz lattice archive (the
hand lattice of ``tests/test_cli.py`` and three host lattices of a small
word-loop graph): stdout and stderr text equal, npz outputs equal array
for array (npz bytes carry zip times), Kaldi-binary arks byte for byte.
Also the verbatim verbs by source text and their place in the verb
table."""

import inspect

import numpy as np
import pytest

from kaldi_cnn_tpu import cli as jcli
from kaldi_cnn_tpu.lang.arpa import estimate_bigram_arpa
from kaldi_cnn_tpu_torch import cli
from kaldi_cnn_tpu_torch.decode.lattice import save_lattices
from kaldi_cnn_tpu_torch.lang.arpa import parse_arpa
from kaldi_cnn_tpu_torch.lang.const_arpa import ConstArpaLm
from test_torch_lattice_io import decoded_lattices

LATTICE_VERBS = (
    "lattice-best-path", "lattice-copy", "lattice-mbr-decode",
    "lattice-nbest", "lattice-prune", "lattice-push", "lattice-minimize",
    "lattice-determinize", "lattice-scale", "lattice-lmrescore",
    "lattice-to-post")
NUM_WORDS = 40


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """lats.npz, its Kaldi-binary ark (by the JAX verb), words.txt over the
    graph's word ids, a bigram ARPA over those words and its const-arpa
    npz."""
    d = tmp_path_factory.mktemp("latverbs")

    def p(name):
        return str(d / name)

    save_lattices(p("lats.npz"), decoded_lattices())
    with open(p("words.txt"), "w") as f:
        f.write("<eps> 0\n" + "".join(f"w{i:02d} {i}\n"
                                      for i in range(1, NUM_WORDS + 1)))
    rng = np.random.default_rng(7)
    text = [[f"w{int(i):02d}" for i in rng.integers(1, NUM_WORDS + 1, n)]
            for n in rng.integers(1, 6, 60)]
    with open(p("lm.arpa"), "w") as f:
        f.write(estimate_bigram_arpa(text))
    vocab = {f"w{i:02d}": i for i in range(1, NUM_WORDS + 1)}
    ConstArpaLm.from_arpa(parse_arpa(open(p("lm.arpa")).read()),
                          vocab).save(p("lm_const.npz"))
    assert jcli.main(["lattice-copy", p("lats.npz"), p("lats.ark")]) == 0
    return p


def run_both(capsys, argv, out=""):
    """Runs ``argv`` through the JAX verb and the port's, with "{out}" in
    ``argv`` replaced by ``out`` with its "{pkg}" set to "jax" or "port";
    asserts the two stdouts and stderrs equal; returns the stdout and the
    two output paths (JAX's, the port's)."""
    res = []
    for pkg, main in (("jax", jcli.main), ("port", cli.main)):
        args = [a.replace("{out}", out.format(pkg=pkg)) for a in argv]
        assert main(args) == 0
        res.append(capsys.readouterr())
    (jo, je), (to, te) = res
    assert to == jo
    assert te == je
    return to, out.format(pkg="jax"), out.format(pkg="port")


def assert_npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        assert x.files
        for k in x.files:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


SCALES = ["--acoustic-scale=0.5", "--lm-scale=1.5"]


@pytest.mark.parametrize("argv", [
    ["lattice-best-path", *SCALES, "--word-ins-penalty=0.5",
     "--word-table={words}", "{lats}"],
    ["lattice-best-path", "{lats}"],
    ["lattice-mbr-decode", *SCALES, "--word-table={words}", "{lats}"],
    ["lattice-nbest", "--n=3", *SCALES, "{lats}"],
    ["lattice-nbest", "--word-table={words}", "{lats}"],
    ["lattice-to-post", *SCALES, "{lats}"],
    ["lattice-copy", "{lats}"],
    ["lattice-copy", "{ark}"],
], ids=lambda a: "_".join(x.strip("-{}").split("=")[0] for x in a))
def test_text_verbs(files, capsys, argv):
    out, _, _ = run_both(capsys, [a.format(words=files("words.txt"),
                                           lats=files("lats.npz"),
                                           ark=files("lats.ark"))
                                  for a in argv])
    assert out.count("utt") >= 4


@pytest.mark.parametrize("argv", [
    ["lattice-prune", "--beam=4", *SCALES],
    ["lattice-push"],
    ["lattice-minimize"],
    ["lattice-determinize", "--max-paths=5", *SCALES],
    ["lattice-scale", "--acoustic-scale=0.1", "--lm-scale=2"],
    ["lattice-lmrescore", "--scale=0.5", "--word-table={words}", "{arpa}"],
    ["lattice-lmrescore", "--scale=-1", "{const}"],
], ids=lambda a: a[0])
def test_npz_verbs(files, capsys, tmp_path, argv):
    argv = [a.format(words=files("words.txt"), arpa=files("lm.arpa"),
                     const=files("lm_const.npz")) for a in argv]
    _, j_out, t_out = run_both(
        capsys, argv + [files("lats.npz"), "{out}"],
        str(tmp_path / "out_{pkg}.npz"))
    assert_npz_equal(t_out, j_out)


def test_lattice_copy_conversions(files, capsys, tmp_path):
    """npz -> Kaldi ark (byte for byte), ark -> npz and npz -> npz (array
    for array)."""
    _, j_ark, t_ark = run_both(
        capsys, ["lattice-copy", files("lats.npz"), "{out}"],
        str(tmp_path / "lat_{pkg}.1"))
    with open(t_ark, "rb") as a, open(j_ark, "rb") as b, \
            open(files("lats.ark"), "rb") as c:
        raw = a.read()
        assert raw == b.read() == c.read()
    for src in (t_ark, files("lats.npz")):
        _, j_npz, t_npz = run_both(capsys, ["lattice-copy", src, "{out}"],
                                   str(tmp_path / "back_{pkg}.npz"))
        assert_npz_equal(t_npz, j_npz)


def test_lattice_verbs_are_verbatim():
    """The verbs' bodies are the JAX package's with the imports pointed at
    the port, and the table maps each name as the JAX one does."""
    for name in ("_lat_scales", "_load_word_table", "_words_str",
                 "cmd_lattice_best_path", "cmd_lattice_copy",
                 "cmd_lattice_mbr", "cmd_lattice_nbest", "cmd_lattice_unary",
                 "cmd_lattice_lmrescore", "cmd_lattice_to_post"):
        want = inspect.getsource(getattr(jcli, name)).replace(
            "kaldi_cnn_tpu.", "kaldi_cnn_tpu_torch.")
        assert inspect.getsource(getattr(cli, name)) == want, name
    for verb in LATTICE_VERBS:
        assert verb in cli.VERBS
        j, t = jcli.VERBS[verb], cli.VERBS[verb]
        if j.__name__ == "<lambda>":
            assert inspect.getsource(t).strip() == inspect.getsource(
                j).strip().replace("kaldi_cnn_tpu.", "kaldi_cnn_tpu_torch.")
        else:
            assert t.__name__ == j.__name__
