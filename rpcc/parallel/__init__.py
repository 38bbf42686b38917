"""Frame-batch data parallelism over a device mesh.

The reference's only distribution axis is frames (python ThreadPoolExecutor,
``tools/compress_datalist.py:202-206``).  Here it is a first-class device
axis: batched encoder/decoder graphs are jit-compiled with batch-dim
shardings over a 1-D ``Mesh(('data',))``, so a datalist run scales across
chips with zero cross-frame communication; host IO and entropy coding overlap
device compute via async dispatch + a thread pool.
"""

from rpcc.parallel.mesh import data_mesh
from rpcc.parallel.engine import BatchEngine
from rpcc.parallel.prefetch import prefetch_loaded_batches
from rpcc.parallel.aggregate import batch_report, make_stats_aggregator
