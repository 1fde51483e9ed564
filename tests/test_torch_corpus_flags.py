"""PyTorch port: ``python -m faceformer_tpu_torch.tools.prepare_data
--backend native`` against ``tools/prepare_data.py`` under the flag sets
test_torch_corpus.py leaves out: ``--no_face_type``,
``--discretize_last``, ``--three_view`` (the four canonical views' SVGs
and PNGs, through the analytic hidden-line removal of
``tools/hlr_visibility.py`` and the PNG writer of ``tools/svg.py``) and
``--only_split``. How the files are compared:
tests/torch_corpus_helpers.py."""

import pytest

from torch_corpus_helpers import (
    PORT_PREPARE,
    check_prepared,
    make_corpus,
    prepared,
    root_script_corpora,
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory)


@pytest.fixture(scope="module")
def jax_corpora(corpus, tmp_path_factory):
    return root_script_corpora(corpus, tmp_path_factory)


@pytest.mark.parametrize("flags", ["no_face_type", "discretize_last", "three_view",
                                   "only_split"])
def test_prepare_data_writes_the_root_scripts_files(flags, corpus, jax_corpora, tmp_path):
    ours = prepared(corpus, str(tmp_path / "port"), PORT_PREPARE, flags, 1)
    check_prepared(corpus, ours, jax_corpora(flags), flags)
