"""Frontend: the batched camodocal camera-model family
(pinhole+radtan, Mei, Kannala-Brandt, Scaramuzza), image kernels
(blur/pyramid/CLAHE/Shi-Tomasi), pyramidal Lucas-Kanade tracking, and the
feature tracker orchestration (replaces src/feature_tracker/* + OpenCV +
camodocal; SURVEY.md §2 rows 4 and the thirdparty camera_models row)."""

from .camera import (  # noqa: F401
    EquidistantCamera,
    MeiCamera,
    OcamCamera,
    PinholeRadtan,
    make_camera,
)
from .tracker import FeatureTracker  # noqa: F401
