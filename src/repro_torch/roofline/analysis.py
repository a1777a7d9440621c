"""Three-term roofline of a step on NVIDIA H100 cards.

The port of ``repro.roofline.analysis``.  The constants are the card's,
named by SKU (as ``backends/torch_backend.HBM_BYTES_PER_S``); no default
stands for a card, so :func:`roofline` takes the SKU.  Per device:

    compute    = flops_per_device / peak bf16 FLOP/s (dense)
    memory     = hbm_bytes_per_device / HBM bytes/s
    collective = the larger of, for each link level, the link bytes that
                 cross it / its bytes/s a direction

Link levels: NVLink joins the ``gpus_per_node`` cards of a node; the
network (one NIC a card) joins nodes.  A collective whose group lies within
one node moves its bytes over NVLink; a group that spans nodes is as fast as
its slowest hop, the network, so all its bytes count there
(:class:`repro_torch.roofline.collectives.CollectiveStats` splits them).
The production mesh's ``model`` axis is 16 wide, so it crosses two 8-card
nodes, and every ``data`` group spans nodes.  The levels are separate links,
so their times overlap as the three terms do.

MODEL_FLOPS is the classic 6·N·D (train) / 2·N·D (inference) with N the
active params (MoE); MODEL_FLOPS / (flops × chips) shows remat and dispatch
overheads.  :func:`slstm_extra_flops` is the reference's correction for the
FLOPs that its ``lax.scan`` hides; the port's sLSTM is a Python loop that a
counter sees step by step, so the port's dry-run does not add it (that
would count them twice).  It is kept for parity.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    peak_flops: float  # bf16 dense, FLOP/s
    hbm_bytes_per_s: float
    nvlink_bytes_per_s: float  # a card's NVLink bytes/s, one direction
    network_bytes_per_s: float  # a card's NIC bytes/s, one direction
    gpus_per_node: int


CHIPS: dict[str, ChipSpec] = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5 part: 989 TFLOP/s bf16
    # dense (1,979 with sparsity), 3.35 TB/s HBM3, NVLink 900 GB/s both
    # directions (450 GB/s one way).  Network: a DGX H100 / HGX node has
    # eight cards and one ConnectX-7 NDR InfiniBand port of 400 Gb/s
    # (50 GB/s one way) a card (NVIDIA DGX H100 user guide).
    "H100 SXM": ChipSpec(989e12, 3.35e12, 450e9, 50e9, 8),
    # The same data sheet, PCIe part: 756 TFLOP/s bf16 dense (1,513 with
    # sparsity), 2.0 TB/s HBM2e, NVLink bridge 600 GB/s both directions
    # between a pair of cards (300 GB/s one way); a 400 Gb/s NIC a card.
    "H100 PCIe": ChipSpec(756e12, 2.0e12, 300e9, 50e9, 2),
}


def chip_sku(device_name: str) -> str | None:
    """The :data:`CHIPS` key of a card named as ``torch.cuda.get_device_name``
    names it ("NVIDIA H100 80GB HBM3" is the SXM part), or ``None``."""
    if "H100" not in device_name:
        return None
    if "PCIe" in device_name:
        return "H100 PCIe"
    if "SXM" in device_name or "HBM3" in device_name:
        return "H100 SXM"
    return None


@dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    hbm_bytes_per_device: float
    link_bytes_per_device: float
    model_flops_global: float
    chips: int
    sku: str
    network_bytes_per_device: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time = max of the three overlap-able terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global)."""
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilisation if the step ran at the roofline bound."""
        if self.bound_s == 0:
            return 0.0
        return self.model_flops_global / (self.chips * CHIPS[self.sku].peak_flops * self.bound_s)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "link_bytes_per_device": self.link_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "chips": self.chips,
            "sku": self.sku,
            "network_bytes_per_device": self.network_bytes_per_device,
        }


def roofline(
    *,
    sku: str,
    flops_per_device: float,
    hbm_bytes_per_device: float,
    link_bytes_per_device: float,
    model_flops_global: float,
    chips: int,
    network_bytes_per_device: float = 0.0,
) -> Roofline:
    """The roofline on ``chips`` cards of ``sku`` (a :data:`CHIPS` key);
    ``network_bytes_per_device`` is the part of ``link_bytes_per_device``
    whose groups span nodes, the rest moves over NVLink."""
    chip = CHIPS[sku]
    if not 0.0 <= network_bytes_per_device <= link_bytes_per_device:
        raise ValueError(f"network bytes {network_bytes_per_device} outside [0, {link_bytes_per_device}]")
    return Roofline(
        compute_s=flops_per_device / chip.peak_flops,
        memory_s=hbm_bytes_per_device / chip.hbm_bytes_per_s,
        collective_s=max(
            (link_bytes_per_device - network_bytes_per_device) / chip.nvlink_bytes_per_s,
            network_bytes_per_device / chip.network_bytes_per_s,
        ),
        flops_per_device=flops_per_device,
        hbm_bytes_per_device=hbm_bytes_per_device,
        link_bytes_per_device=link_bytes_per_device,
        model_flops_global=model_flops_global,
        chips=chips,
        sku=sku,
        network_bytes_per_device=network_bytes_per_device,
    )


def model_flops(cfg, shape) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (serve)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def slstm_extra_flops(cfg, shape) -> float:
    """The reference's analytic FLOPs hidden in its sLSTM ``lax.scan``
    (``cost_analysis`` counts the while body once).  Per step: 4 recurrent
    matmuls (2·d² each) + ~20·d elementwise, per token, per sLSTM layer.
    Not added to the port's counts (see the module docstring)."""
    n_slstm = sum(1 for mix, _ in cfg.layer_seq() if mix == "slstm")
    if n_slstm == 0:
        return 0.0
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.seq_len * shape.global_batch
    per_token_layer = 4 * 2 * cfg.d_model**2 + 20 * cfg.d_model
    return float(n_slstm) * tokens * per_token_layer
