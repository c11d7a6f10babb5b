"""The port's multi-process layer over torch.distributed (the JAX
package's comfyui_keep_tpu/parallel/): process groups and collectives,
chunk-parallel restore, the carried-state ring and tensor-parallel
shards."""
from comfyui_keep_torch.parallel.mesh import (Mesh, broadcast_module,
                                              get_dist_info, init_distributed,
                                              make_mesh, reduce_loss_dict,
                                              shard_batch)
from comfyui_keep_torch.parallel.inference import restore_chunks_parallel
from comfyui_keep_torch.parallel.sequence import restore_stream_pipeline
