"""Entry-point binaries (the port of ``gubernator_tpu/cmd``; the
reference's cmd/ tree):

* ``python -m gubernator_tpu_torch``                 — server daemon
* ``python -m gubernator_tpu_torch.cmd.cli``         — load generator
* ``python -m gubernator_tpu_torch.cmd.cluster``     — local in-process cluster
* ``python -m gubernator_tpu_torch.cmd.healthcheck`` — k8s probe

The server and the cluster take ``--device``: without it their engines run
on the card and raise when there is none.
"""
