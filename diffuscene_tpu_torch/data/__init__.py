from .raw import Asset, BaseThreedFutureModel, ThreedFutureModel
from .threed_future import ThreedFutureDataset, ThreedFutureNormPCDataset
