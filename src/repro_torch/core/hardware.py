"""Hardware constants and cluster topology (a copy of
``repro.core.hardware``: ``Chip``, ``Tier``, ``ClusterSpec`` with its JSON
form, ``MeshSpec``, ``SINGLE_POD`` / ``MULTI_POD`` and the named clusters).

- ``Chip.hbm_bytes``  -> Eq. (5)'s device memory ``M_GPU``  [bytes]
- ``Chip.peak_flops`` -> the ``T_C`` denominator of the planner's step-time
  roofline (``core.planner.estimate_step_time``)            [FLOP/s]

- ``Tier.bw``      -> Lemma 3.2's server bandwidth ``B_ps`` and the
  collective wire bandwidth, per interconnect tier          [bytes/s]
- ``Tier.latency`` -> the per-phase constant added to each collective hop
  at that tier                                              [s]

The chips are the JAX package's (a TPU v5e-class part and the paper's
K80) and the card the port runs on, the H100 SXM, with its named
clusters: one 8-card NVLink node and two such nodes over InfiniBand.
Every number is a data-sheet number, not a measurement.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float  # FLOP/s at the training dtype
    hbm_bytes: float
    hbm_bw: float  # bytes/s
    link_bw: float  # bytes/s per ICI/interconnect link

    # a calibrated overlay (core.autotune.Calibration) carries this suffix
    # on the chip's name; plans it priced name it in their topology
    CAL_SUFFIX = "+cal"

    def scaled(self, *, peak_flops: Optional[float] = None,
               hbm_bw: Optional[float] = None,
               link_bw: Optional[float] = None) -> "Chip":
        """A *calibrated* overlay of this chip: same identity, data-sheet
        constants replaced by measured ones (``core.autotune``).  The name
        gains a ``+cal`` marker so plans priced on measurements are
        distinguishable from data-sheet plans."""
        name = (self.name if self.name.endswith(self.CAL_SUFFIX)
                else self.name + self.CAL_SUFFIX)
        return replace(
            self, name=name,
            peak_flops=peak_flops if peak_flops else self.peak_flops,
            hbm_bw=hbm_bw if hbm_bw else self.hbm_bw,
            link_bw=link_bw if link_bw else self.link_bw)

    @property
    def calibrated(self) -> bool:
        return self.name.endswith(self.CAL_SUFFIX)


TPU_V5E = Chip(
    name="tpu-v5e",
    peak_flops=197e12,  # bf16
    hbm_bytes=16 * 2**30,
    hbm_bw=819e9,
    link_bw=50e9,
)

# Paper-era: NVIDIA GK210 (one half of a K80), AWS P2 instances (Table 1)
K80_GK210 = Chip(
    name="k80-gk210",
    peak_flops=2.91e12,
    hbm_bytes=12 * 2**30,
    hbm_bw=240e9,
    link_bw=10e9 / 8,  # 10 Gbit Ethernet (p2.8xlarge "network" as PS link)
)


# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core rate, HBM3, and
# NVLink 4 at 900 GB/s per card both ways, 450e9 B/s per direction
H100_SXM = Chip(
    name="h100-sxm",
    peak_flops=989e12,  # bf16, dense
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    link_bw=450e9,
)
# NVIDIA DGX H100 data sheet: eight single-port ConnectX-7 NICs at
# 400 Gb/s (InfiniBand NDR), one per card: 50e9 B/s per card per direction
H100_IB_BW = 400e9 / 8


@dataclass(frozen=True)
class Tier:
    """One level of the interconnect hierarchy: ``size`` is the fan-out
    at this level (the innermost tier groups chips into a node, the next
    groups nodes, ...); ``bw`` is bytes/s per chip across this tier."""

    name: str
    size: int
    bw: float  # bytes/s per chip across this tier's links
    latency: float = 0.0  # seconds per collective phase at this tier

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"tier {self.name!r}: size must be >= 1")
        if self.bw <= 0:
            raise ValueError(f"tier {self.name!r}: bw must be > 0")
        if self.latency < 0:
            raise ValueError(f"tier {self.name!r}: latency must be >= 0")


@dataclass(frozen=True)
class ClusterSpec:
    """A hierarchy of tiers, innermost first (chip -> node -> cluster).
    The total chip count is the product of the tier sizes."""

    name: str
    chip: Chip = TPU_V5E
    tiers: Tuple[Tier, ...] = (Tier("pod", 1, TPU_V5E.link_bw),)

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("ClusterSpec needs at least one tier")
        object.__setattr__(self, "tiers", tuple(self.tiers))

    @property
    def n_chips(self) -> int:
        return math.prod(t.size for t in self.tiers)

    @property
    def tier_sizes(self) -> Tuple[int, ...]:
        return tuple(t.size for t in self.tiers)

    @property
    def tier_bws(self) -> Tuple[float, ...]:
        return tuple(t.bw for t in self.tiers)

    @property
    def uniform(self) -> bool:
        """True when there is no bandwidth hierarchy to exploit: at most
        one tier spans more than one group (the flat-mesh case)."""
        return sum(1 for t in self.tiers if t.size > 1) <= 1

    @property
    def min_bw(self) -> float:
        """Bandwidth of the narrowest *spanning* tier (size > 1): what a
        flat (topology-blind) collective is priced at."""
        spanning = [t.bw for t in self.tiers if t.size > 1]
        return min(spanning) if spanning else self.tiers[0].bw

    @property
    def bottleneck_tier(self) -> str:
        spanning = [t for t in self.tiers if t.size > 1] or list(self.tiers)
        return min(spanning, key=lambda t: t.bw).name

    def dp_view(self, dp: int, tp: int) -> Tuple[Tier, ...]:
        """The tiers as seen by the data axis when ``tp`` model-parallel
        ranks are packed into the innermost tiers first.  Consumes ``tp``
        from the inside out and returns the residual per-tier dp fan-out."""
        if dp * tp != self.n_chips:
            raise ValueError(f"dp*tp = {dp * tp} != n_chips = {self.n_chips} "
                             f"for cluster {self.name!r}")
        out: List[Tier] = []
        rem_tp = tp
        for t in self.tiers:
            take = math.gcd(t.size, rem_tp)
            rem_tp //= take
            out.append(replace(t, size=t.size // take))
        if rem_tp != 1:  # tp does not factor along tiers: flat fallback
            return (Tier(self.bottleneck_tier, dp, self.min_bw),)
        return tuple(out)

    # -- serialization (a Plan carries its cluster as this dict) ----------
    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "chip": self.chip.name,
            "tiers": [{"name": t.name, "size": t.size, "bw": t.bw,
                       "latency": t.latency} for t in self.tiers],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ClusterSpec":
        chips = {c.name: c for c in CHIPS}
        chip_name = d.get("chip", TPU_V5E.name)
        # calibrated overlays serialize as "<chip>+cal"; the measured
        # constants live in the tier bandwidths, so deserialization falls
        # back to the data-sheet base chip
        if chip_name.endswith(Chip.CAL_SUFFIX):
            chip_name = chip_name[:-len(Chip.CAL_SUFFIX)]
        if chip_name not in chips:
            raise KeyError(f"unknown chip {chip_name!r} in serialized "
                           f"cluster {d.get('name')!r}; known: {sorted(chips)}")
        return cls(
            name=d["name"],
            chip=chips[chip_name],
            tiers=tuple(Tier(t["name"], int(t["size"]), float(t["bw"]),
                             float(t.get("latency", 0.0)))
                        for t in d["tiers"]),
        )

    @classmethod
    def flat(cls, chips: int, bw: Optional[float] = None, *,
             chip: Chip = TPU_V5E, name: str = "") -> "ClusterSpec":
        """Single-tier cluster."""
        return cls(name=name or f"flat{chips}", chip=chip,
                   tiers=(Tier("pod", chips, bw or chip.link_bw),))


# the chips a serialized cluster may name
CHIPS = (TPU_V5E, K80_GK210, H100_SXM)


@dataclass(frozen=True)
class MeshSpec:
    """Mesh geometry (dp x tp) + the cluster topology it maps onto."""

    chips: int
    dp: int  # data-parallel degree (pod*data)
    tp: int  # model-parallel degree
    chip: Chip = TPU_V5E
    topology: Optional[ClusterSpec] = None  # None => flat single tier

    @property
    def total_flops(self) -> float:
        return self.chips * self.chip.peak_flops

    @property
    def total_hbm(self) -> float:
        return self.chips * self.chip.hbm_bytes

    @property
    def cluster(self) -> ClusterSpec:
        """The topology, or its flat single-tier equivalent when omitted."""
        if self.topology is not None:
            return self.topology
        return ClusterSpec.flat(self.chips, self.chip.link_bw, chip=self.chip)

    @classmethod
    def from_cluster(cls, cluster: ClusterSpec, *, tp: int = 1) -> "MeshSpec":
        n = cluster.n_chips
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {n} chips")
        return cls(chips=n, dp=n // tp, tp=tp, chip=cluster.chip,
                   topology=cluster)


# the JAX package's default meshes: one 256-chip TPU v5e pod, and two such
# pods over the data-center network
SINGLE_POD = MeshSpec(chips=256, dp=16, tp=16)
MULTI_POD = MeshSpec(
    chips=512, dp=32, tp=16,
    topology=ClusterSpec(
        "2pod-dcn", TPU_V5E,
        (Tier("pod", 256, TPU_V5E.link_bw), Tier("dcn", 2, 25e9))))


# The named clusters JobSpec.topology addresses (the JAX package's CLUSTERS)
CLUSTERS: Dict[str, ClusterSpec] = {
    "flat8": ClusterSpec.flat(8, name="flat8"),
    "flat16": ClusterSpec.flat(16, name="flat16"),
    # 2 nodes x 4 chips: fast links in-node, 20 Gbit/s-class across
    "2x4": ClusterSpec("2x4", TPU_V5E,
                       (Tier("node", 4, TPU_V5E.link_bw),
                        Tier("cluster", 2, 2.5e9))),
    # 4 nodes x 4 chips over 100 Gbit InfiniBand-class links
    "4x4-ib": ClusterSpec("4x4-ib", TPU_V5E,
                          (Tier("node", 4, TPU_V5E.link_bw),
                           Tier("cluster", 4, 12.5e9))),
    # paper-era: 2 x p2.8xlarge (8 GK210s behind PCIe, 10 GbE between)
    "p2-2x8": ClusterSpec("p2-2x8", K80_GK210,
                          (Tier("node", 8, 10e9),
                           Tier("cluster", 2, 10e9 / 8))),
    "pod": ClusterSpec.flat(256, name="pod"),
    "2pod-dcn": MULTI_POD.topology,
    # one 8 x H100 SXM node (HGX / DGX H100): every card on NVLink
    "h100-8": ClusterSpec("h100-8", H100_SXM,
                          (Tier("node", 8, H100_SXM.link_bw),)),
    # two such nodes, one 400 Gb/s InfiniBand NIC per card between them
    "h100-2x8": ClusterSpec("h100-2x8", H100_SXM,
                            (Tier("node", 8, H100_SXM.link_bw),
                             Tier("cluster", 2, H100_IB_BW))),
}
# the cluster the data-parallel trainer prices its sync on when it runs on
# cards and the caller names neither a topology nor a link bandwidth
H100_NODE = CLUSTERS["h100-8"]


def get_cluster(name: str) -> ClusterSpec:
    try:
        return CLUSTERS[name]
    except KeyError:
        raise KeyError(f"unknown cluster {name!r}; known: "
                       f"{sorted(CLUSTERS)}") from None
