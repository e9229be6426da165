"""Domain constants: the port's copy of ``ark_tpu/settings.py``, value for
value, so that the tables both packages write interoperate. The example
dataset's revision is left out with the downloader it belongs to."""

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

# --- MIBI stage-coordinate calibration ---------------------------------
REGION_PARAM_FIELDS = [
    "region_start_x", "region_start_y", "fov_num_x", "fov_num_y",
    "x_fov_size", "y_fov_size", "region_rand",
]
MICRON_TO_STAGE_X_MULTIPLIER = 0.001001
MICRON_TO_STAGE_X_OFFSET = 0.3116
MICRON_TO_STAGE_Y_MULTIPLIER = 0.001018
MICRON_TO_STAGE_Y_OFFSET = 0.6294
STAGE_TO_PIXEL_X_MULTIPLIER = 1 / 0.06887
STAGE_TO_PIXEL_X_OFFSET = 27.79
STAGE_TO_PIXEL_Y_MULTIPLIER = 1 / -0.06926
STAGE_TO_PIXEL_Y_OFFSET = -77.40

# --- spatial-LDA -------------------------------------------------------
BASE_COLS = [FOV_ID, CELL_LABEL, CELL_SIZE, CENTROID_0, CENTROID_1, CELL_TYPE]
EDA_KEYS = ["inertia", "silhouette", "gap_stat", "gap_sds", "cell_counts",
            "featurization"]
LDA_PLOT_TYPES = ["adjacency", "topic_assignment"]

# --- external services -------------------------------------------------
MIBITRACKER_BACKEND = "https://backend-dot-mibitracker-angelolab.appspot.com"
