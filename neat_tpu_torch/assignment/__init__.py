from .clustering import dbscan_callback_means, dbscan_cluster_means
from .matching import auction_assignment, hungarian_callback, masked_assignment
