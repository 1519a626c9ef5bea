"""Static configuration of the SLAM pipeline (reference:
ITMLib/Utils/ITMLibDefines.h:37-62, ITMLib/Utils/ITMLibSettings.{h,cpp}).

The port's own copy of infinitam_tpu/config.py, so that the port runs with
no part of the JAX package present. Class names, field names, defaults and
enum values are the same, so a configuration means the same in both
packages. tests/test_torch_config.py fails on any drift between the two
copies: a field or default changed in one file is changed in the other in
the same commit. The port reads Settings by
field and compares enums by value, so it also accepts a Settings of the JAX
package; the parity tests hand one Settings to both.

Fields that configure only the Pallas kernels (`use_pallas_*`,
`raycast_t_march`, `raycast_pages_per_tile`, `raycast_pages_small`,
`raycast_page_blocks`) are kept for that equality and ignored by the port,
whose CUDA kernels have no page lists or tiers.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class TrackerType(enum.Enum):
    """Camera tracker selection (reference: ITMLibSettings.h:22-37)."""

    COLOR = "color"
    ICP = "icp"
    REN = "ren"
    IMU = "imu"
    WICP = "wicp"
    EXTERNAL = "external"


class SwappingMode(enum.Enum):
    DISABLED = "disabled"
    ENABLED = "enabled"


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """TSDF volume parameters (reference: ITMLib/Objects/ITMSceneParams.h,
    defaults from ITMLibSettings.cpp:10)."""

    voxel_size: float = 0.005  # metres
    mu: float = 0.02  # TSDF truncation band, metres
    max_w: int = 100  # fusion running-average weight cap
    view_frustum_min: float = 0.35  # metres
    view_frustum_max: float = 3.0  # metres
    stop_integrating_at_max_w: bool = False


@dataclasses.dataclass(frozen=True)
class VoxelBlockHashParams:
    """Sparse voxel-block-hash capacities (reference: ITMLibDefines.h:37-62):
    2^20 ordered buckets, 2^17 excess entries, 2^16 live blocks of 8³ voxels.
    Every capacity is a fixed tensor size; tests use much smaller ones."""

    block_size: int = 8  # voxels per block edge (SDF_BLOCK_SIZE)
    n_buckets: int = 0x100000  # ordered part of the hash table (SDF_BUCKET_NUM)
    n_excess: int = 0x20000  # excess (collision) list size (SDF_EXCESS_LIST_SIZE)
    n_blocks: int = 0x10000  # live voxel blocks on device (SDF_LOCAL_BLOCK_NUM)
    n_transfer_blocks: int = 0x1000  # swap slab size (SDF_TRANSFER_BLOCK_NUM)
    n_global_blocks: int = 0x120000  # host-side store (SDF_GLOBAL_BLOCK_NUM)
    # visible-list capacity, sized to real visibility (~2 k blocks at 1 cm,
    # ~8 k at 5 mm for a 640×480 frustum); overflow is counted in
    # FrameDiagnostics.n_render_overflow
    max_visible_blocks: int = 0x4000

    @property
    def block_volume(self) -> int:
        return self.block_size**3

    @property
    def n_entries(self) -> int:
        return self.n_buckets + self.n_excess

    @property
    def hash_mask(self) -> int:
        return self.n_buckets - 1


@dataclasses.dataclass(frozen=True)
class PlainVoxelArrayParams:
    """Dense voxel volume extents (reference: ITMPlainVoxelArray.h:27-37,
    default 512³ with offset (−256, −256, 0))."""

    size: Tuple[int, int, int] = (512, 512, 512)
    offset: Tuple[int, int, int] = (-256, -256, 0)


@dataclasses.dataclass(frozen=True)
class BlockGridParams:
    """The dense cell → VBA-row grid over the working volume, so a voxel read
    is one int gather instead of a hash-chain walk. The hash table stays
    canonical; blocks outside the grid read as unallocated."""

    dims: Tuple[int, int, int] = (64, 64, 64)  # blocks, stored xyz
    origin: Tuple[int, int, int] = (-32, -32, 0)  # block coords of the grid corner


@dataclasses.dataclass(frozen=True)
class TrackingParams:
    """Hierarchical tracker regime (reference: ITMLibSettings.cpp:30-55,
    ITMDepthTracker.cpp:19-28)."""

    n_levels: int = 5
    # Gauss-Newton iterations per level, index 0 = finest (reference: 2, +2
    # per coarser level)
    iterations_per_level: Tuple[int, ...] = (2, 4, 6, 8, 10)
    # ICP distance gate at the coarsest level, metres²; each finer level
    # subtracts dist_thresh / n_levels
    dist_thresh: float = 0.1 * 0.1
    termination_threshold: float = 1e-3
    # rotation-only iterations at this many coarsest levels
    n_rotation_only_levels: int = 2
    # minimum valid points for a usable system (reference noValidPoints > 100)
    min_valid_points: int = 100
    # divergence policy: a frame whose final energy exceeds this keeps the
    # last good pose and is not fused (f = 1e5 when N ≤ min_valid); ≤ 0 off
    divergence_f_threshold: float = 1e4
    # run ICP only down to this level (reference noICPRunTillLevel = 0)
    no_icp_run_till_level: int = 0
    use_pallas_icp: bool = True  # Pallas-only: ignored by the port
    # colour tracker
    color_n_levels: int = 4
    color_skip_points: bool = True


@dataclasses.dataclass(frozen=True)
class Settings:
    """Top-level runtime settings (reference: ITMLib/Utils/ITMLibSettings.h)."""

    scene: SceneParams = SceneParams()
    hashing: VoxelBlockHashParams = VoxelBlockHashParams()
    plain: PlainVoxelArrayParams = PlainVoxelArrayParams()
    block_grid: BlockGridParams = BlockGridParams()
    use_block_grid: bool = True  # raycast through the dense block grid
    # allocation-ray pixel stride (1 = every pixel); a block must span ≥ 2
    # strides at the far plane so that every surface block is tapped
    alloc_subsample: int = 4
    # coarse raycast pass at 1/factor resolution (1 = off)
    raycast_coarse_factor: int = 1
    # Pallas-only raycast and integrate settings: ignored by the port
    use_pallas_raycast: bool = True
    raycast_t_march: int = 64
    raycast_pages_per_tile: int = 32
    raycast_pages_small: int = 16
    raycast_page_blocks: int = 4096
    use_pallas_integrate: bool = True
    tracking: TrackingParams = TrackingParams()
    tracker_type: TrackerType = TrackerType.ICP
    swapping_mode: SwappingMode = SwappingMode.DISABLED
    use_approximate_raycast: bool = False
    use_bilateral_filter: bool = False
    model_sensor_noise: bool = False  # fills normals + uncertainty in the view
    use_color: bool = False  # fuse RGB into the volume
    skip_points: bool = True  # subsample point cloud extraction 2×
    # raycast expected-depth subsampling (reference minmaximg_subsample = 8)
    minmax_subsample: int = 8
    # cap on blocks fused per frame (0 = the whole visible list); blocks
    # beyond it keep their values and fuse on a later frame
    max_fused_blocks: int = 8192
    # cap on visible blocks rasterised into the expected-depth image
    max_render_blocks: int = 8192
    # cap on new blocks allocated per frame; overflow defers to the next frame
    max_alloc_blocks: int = 8192

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


def safe_alloc_stride(settings: Settings, focal_px: float) -> int:
    """The largest allocation-ray stride that still puts ≥ 2 taps across a
    block's projected footprint at the far frustum plane (derived from
    voxel_size · block_size, the focal length and view_frustum_max)."""
    block_m = settings.scene.voxel_size * settings.hashing.block_size
    min_footprint_px = focal_px * block_m / settings.scene.view_frustum_max
    return max(1, int(min_footprint_px // 2))


def assert_alloc_stride_safe(settings: Settings, focal_px: float) -> None:
    """Raise ValueError when `alloc_subsample` exceeds safe_alloc_stride:
    surface blocks between allocation rays would be silently missed."""
    safe = safe_alloc_stride(settings, focal_px)
    if settings.alloc_subsample > safe:
        raise ValueError(
            f"alloc_subsample={settings.alloc_subsample} exceeds the safe "
            f"stride {safe} for voxel {settings.scene.voxel_size} m × block "
            f"{settings.hashing.block_size} at f={focal_px:.0f} px, far plane "
            f"{settings.scene.view_frustum_max} m — surface blocks between "
            "allocation rays would be silently missed"
        )


def tiny_test_settings() -> Settings:
    """Small capacities for fast CPU tests (alloc stride 2: the default
    stride 4 is sized for 640×480)."""
    return Settings(
        scene=SceneParams(voxel_size=0.02, mu=0.08),
        alloc_subsample=2,
        hashing=VoxelBlockHashParams(
            n_buckets=0x1000,
            n_excess=0x200,
            n_blocks=0x800,
            n_transfer_blocks=0x100,
            n_global_blocks=0x1000,
            max_visible_blocks=0x800,
        ),
        plain=PlainVoxelArrayParams(size=(128, 128, 128), offset=(-64, -64, 0)),
    )
