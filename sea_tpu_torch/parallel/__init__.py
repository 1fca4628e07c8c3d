"""The port's parallel paths: the data- and tensor-parallel mesh
(``--mesh DxM``), sequence parallelism (``--seq_parallel N``) and the
pipeline (``--pp S``).

Counterpart of ``sea_tpu/parallel/``. The JAX
package runs one process that drives every device through GSPMD; the
port runs one process per rank, as torch does (``torchrun`` on a
multi-GPU host, ``torch.multiprocessing`` in the tests), and issues the
collectives GSPMD inserts itself:

- ``multihost``: ``torch.distributed`` from the torchrun environment;
- ``mesh``: the (data, model) grid of ranks and the seq ring, and the
  tensor-parallel slicing of a parameter tree (the JAX partition specs,
  as slices);
- ``collectives``: the Megatron operators, the data-group gradient sum,
  the point-to-point ``ring_shift`` and the grid the model code reads
  while it runs sharded;
- ``train_step``: the sharded temporal and spatial train steps, the
  sequence-parallel temporal step and the sharded rollout;
- ``ring_attention``: attention over a time axis split across a ring of
  ranks, on the flash kernels;
- ``pipeline``: GPipe over (data, pipe) ranks.
"""
