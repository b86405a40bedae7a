"""Data parallelism across processes: one process per card.

Port of ``csmri_refinement_tpu/parallel``. The JAX package declares one
GSPMD mesh over every device of every process; PyTorch has no such mesh,
so each process runs the model on its own card on its contiguous slice of
every global batch (``DataLoader(process_shard=...)``), and the runners
average the gradients and the fetched losses over the process group,
synchronise the BatchNorm statistics in train mode and gather the
validation outputs before the metrics. ``distributed.initialize`` starts
the group (config ``distributed`` section, the JAX cluster environment or
torchrun's); ``mesh.mesh_from_conf`` reads the config's ``mesh`` section.
Its ``spatial`` axis shards each image's rows over the ranks of a spatial
group as well (``halo``: the halo rows of the convs, the DC's row
gathers).
"""

from csmri_refinement_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, gather_to_replicated, mesh_from_conf, multiprocess, replicate,
    shard_batch, shard_stacked_batch)
