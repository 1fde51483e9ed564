"""Dataset curation filters (reference: dataset/filters/*).

A copy of faceformer_tpu/tools/filters/, stage for stage.

Pipeline order (reference dataset/README.md): topology bins -> 3-view
dedup -> length -> thickness -> thinness. Each stage reads/writes id-list
JSONs so stages compose and resume.
"""
