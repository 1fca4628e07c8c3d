"""The data- and tensor-parallel mesh of the port (``--mesh DxM``).

Counterpart of ``sea_tpu/parallel/`` for its ``mesh`` paths. The JAX
package runs one process that drives every device through GSPMD; the
port runs one process per rank, as torch does (``torchrun`` on a
multi-GPU host, ``torch.multiprocessing`` in the tests), and issues the
collectives GSPMD inserts itself:

- ``multihost``: ``torch.distributed`` from the torchrun environment;
- ``mesh``: the (data, model) grid of ranks, and the tensor-parallel
  slicing of a parameter tree (the JAX partition specs, as slices);
- ``collectives``: the Megatron operators, the data-group gradient sum
  and the grid the model code reads while it runs sharded;
- ``train_step``: the sharded temporal and spatial train steps and the
  sharded rollout.

Sequence parallelism (the ring) and the pipeline are not ported yet
(ROADMAP.md).
"""
