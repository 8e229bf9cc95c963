from ...models.buffer import Buffer
from ...models.model import Model

__all__ = ["Buffer", "Model"]
