from .raw import Asset, BaseThreedFutureModel, ThreedFutureModel
from .threed_future import ThreedFutureDataset, ThreedFutureNormPCDataset
from .encoding import Bounds, EncodingPipeline, build_encoding
from .loader import DataLoader, EncodedDataset, PackedDataLoader, collate
from .factory import get_dataset_raw_and_encoded, get_encoded_dataset, get_raw_dataset
from .splits import CSVSplitsBuilder
from .synthetic import (make_synthetic_cached_dataset, make_synthetic_catalog,
                        make_synthetic_raw_front)
from .threed_front import CachedThreedFront
