from semicp.corr.bruteforce import class_nn, knn_self  # noqa: F401
from semicp.corr.layout import (  # noqa: F401
    LAYOUT_CM,
    sort_cloud_cm,
    tile_candidates,
    tile_meta,
)
from semicp.corr.sparse_nn import (  # noqa: F401
    class_nn_attrs_sparse,
    class_nn_attrs_xla,
    prepare_sparse,
)
