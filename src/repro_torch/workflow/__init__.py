"""Fault-tolerance primitives (:mod:`~repro_torch.workflow.fault`), the one
module of ``repro.workflow`` the port needs: :mod:`repro_torch.exec.policy`
builds its retry engine from it."""
