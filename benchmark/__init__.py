"""The benchmark of ``csmri_refinement_tpu_torch`` on an NVIDIA H100.

``run.py`` runs one cell once; ``README.md`` gives the layout.
"""
