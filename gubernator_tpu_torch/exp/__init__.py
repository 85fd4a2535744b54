"""Ports of the TPU measurement scripts in ``exp/`` that hold Pallas
kernels: ``exp_sweep2``, ``exp_sweep4``, ``exp_sweep5`` and ``exp_mem2``,
each runnable as ``python -m gubernator_tpu_torch.exp.<name>``, over the
four sweep kernels of ``sweeps``."""
