"""Domain constants of the cell table: the port's copy of the parts of
``ark_tpu/settings.py`` it uses, value for value, so that the tables both
packages write interoperate."""

# --- cell-table schema -------------------------------------------------
# the channel block of a cell table is delimited by PRE_CHANNEL_COL on the
# left and POST_CHANNEL_COL on the right
CELL_SIZE = "cell_size"
CELL_LABEL = "label"
FOV_ID = "fov"
CELL_TYPE = "cell_meta_cluster"
CELL_TYPE_NUM = "cell_num"
PATIENT_ID = "PatientID"
KMEANS_CLUSTER = "kmeans_neighborhood"
CENTROID_0 = "centroid-0"
CENTROID_1 = "centroid-1"

PRE_CHANNEL_COL = CELL_SIZE
POST_CHANNEL_COL = CELL_LABEL

# --- morphology feature sets -------------------------------------------
REGIONPROPS_BASE = [
    "label",
    "area",
    "eccentricity",
    "major_axis_length",
    "minor_axis_length",
    "perimeter",
    "centroid",
    "convex_area",
    "equivalent_diameter",
]
REGIONPROPS_SINGLE_COMP = [
    "major_minor_axis_ratio",
    "perim_square_over_area",
    "major_axis_equiv_diam_ratio",
    "convex_hull_resid",
    "centroid_dif",
    "num_concavities",
]
REGIONPROPS_MULTI_COMP = ["nc_ratio"]

FIBER_OBJECT_PROPS = (
    "label",
    "centroid",
    "major_axis_length",
    "minor_axis_length",
    "orientation",
    "area",
    "eccentricity",
    "euler_number",
)

# --- spatial-LDA -------------------------------------------------------
BASE_COLS = [FOV_ID, CELL_LABEL, CELL_SIZE, CENTROID_0, CENTROID_1, CELL_TYPE]
LDA_PLOT_TYPES = ["adjacency", "topic_assignment"]
