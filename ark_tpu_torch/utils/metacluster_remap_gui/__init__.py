from .colormap_helper import (distinct_cmap, distinct_rgbs,  # noqa: F401
                              generate_meta_cluster_colormap_dict)
from .file_reader import metaclusterdata_from_files  # noqa: F401
from .metaclusterdata import MetaClusterData  # noqa: F401
from .metaclustergui import MetaClusterGui  # noqa: F401
from .zscore_norm import ZScoreNormalize  # noqa: F401
