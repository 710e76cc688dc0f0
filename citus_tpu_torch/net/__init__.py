from citus_tpu_torch.net.rpc import RpcClient, RpcServer

__all__ = ["RpcClient", "RpcServer"]
