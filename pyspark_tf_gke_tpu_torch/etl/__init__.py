"""The ETL plane's native chain (counterpart of
``pyspark_tf_gke_tpu/etl/``): the feature pipeline, KMeans on the
device, the silhouette, the bridge's TFRecord writers and the text
bridge's executor body. The Spark, JDBC and MySQL glue is P12's."""

from pyspark_tf_gke_tpu_torch.etl.feature_pipeline import FeaturePipeline
from pyspark_tf_gke_tpu_torch.etl.kmeans import KMeans, silhouette_score

__all__ = ["FeaturePipeline", "KMeans", "silhouette_score"]
