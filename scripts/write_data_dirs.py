#!/usr/bin/env python3
"""Writes Kaldi data directories of the synthetic corpora, for the
recipes' ``--data-dir`` flags and the command-line verbs:

    python3 scripts/write_data_dirs.py OUT

gives ``OUT/yesno`` (the yesno recipe's own 100-utterance corpus, seed
17, with its ``lexicon.txt`` inside) and ``OUT/wsj`` (``wsj.make_corpus``
at its default 160 utterances, seed 37) with ``OUT/wsj_lexicon.txt``;
then

    python3 -m kaldi_cnn_tpu_torch.recipes.yesno --data-dir OUT/yesno
    python3 -m kaldi_cnn_tpu_torch.recipes.wsj --data-dir OUT/wsj \\
        --lexicon OUT/wsj_lexicon.txt
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from kaldi_cnn_tpu_torch.recipes import synthetic, wsj  # noqa: E402
from kaldi_cnn_tpu_torch.recipes.datadir import (  # noqa: E402
    write_data_dir, write_lexicon_file)


def main(out: str) -> None:
    lex = synthetic.yesno_lexicon()
    c = synthetic.make_corpus(lex, {"yes": 0.5, "no": 0.5}, 100, 1, 3, 17)
    write_data_dir(os.path.join(out, "yesno"), c.waves, c.transcripts,
                   None, c.sample_rate)
    write_lexicon_file(os.path.join(out, "yesno", "lexicon.txt"), lex)
    c = wsj.make_corpus(160, 37)
    write_data_dir(os.path.join(out, "wsj"), c.waves, c.transcripts, None,
                   c.sample_rate)
    write_lexicon_file(os.path.join(out, "wsj_lexicon.txt"), c.lexicon)
    print(f"data dirs in {out}")


if __name__ == "__main__":
    main(sys.argv[1])
