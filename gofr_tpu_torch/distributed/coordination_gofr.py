"""Generated by gofr-tpu-torch grpc codegen (grpcx/codegen.py) from coordination.proto — DO NOT EDIT."""

from __future__ import annotations

import base64
from typing import Any

from gofr_tpu_torch.grpcx.h2 import Channel
from gofr_tpu_torch.grpcx.runtime import GofrGrpcService, GofrStream, load_messages

_FDS = base64.b64decode(
    'CpwMChJjb29yZGluYXRpb24ucHJvdG8SD2dvZnIuY2x1c3Rlci52MSLiAQoPUmVnaXN0ZXJSZXF1ZXN0EhcKB2hv'
    'c3RfaWQYASABKAlSBmhvc3RJZBIYCgdhZGRyZXNzGAIgASgJUgdhZGRyZXNzEhsKCW5fZGV2aWNlcxgDIAEoBVII'
    'bkRldmljZXMSRAoGbGFiZWxzGAQgAygLMiwuZ29mci5jbHVzdGVyLnYxLlJlZ2lzdGVyUmVxdWVzdC5MYWJlbHNF'
    'bnRyeVIGbGFiZWxzGjkKC0xhYmVsc0VudHJ5EhAKA2tleRgBIAEoCVIDa2V5EhQKBXZhbHVlGAIgASgJUgV2YWx1'
    'ZToCOAEi5QEKEFJlZ2lzdGVyUmVzcG9uc2USGgoIYWNjZXB0ZWQYASABKAhSCGFjY2VwdGVkEhQKBWVwb2NoGAIg'
    'ASgEUgVlcG9jaBI7Cgphc3NpZ25tZW50GAMgASgLMhsuZ29mci5jbHVzdGVyLnYxLkFzc2lnbm1lbnRSCmFzc2ln'
    'bm1lbnQSMAoUaGVhcnRiZWF0X2ludGVydmFsX3MYBCABKAJSEmhlYXJ0YmVhdEludGVydmFsUxIwChRoZWFydGJl'
    'YXRfZGVhZGxpbmVfcxgFIAEoAlISaGVhcnRiZWF0RGVhZGxpbmVTImIKEEhlYXJ0YmVhdFJlcXVlc3QSFwoHaG9z'
    'dF9pZBgBIAEoCVIGaG9zdElkEhQKBWVwb2NoGAIgASgEUgVlcG9jaBIfCgtoZWFsdGhfanNvbhgDIAEoCVIKaGVh'
    'bHRoSnNvbiJ2ChFIZWFydGJlYXRSZXNwb25zZRIOCgJvaxgBIAEoCFICb2sSFAoFZXBvY2gYAiABKARSBWVwb2No'
    'EjsKCmFzc2lnbm1lbnQYAyABKAsyGy5nb2ZyLmNsdXN0ZXIudjEuQXNzaWdubWVudFIKYXNzaWdubWVudCJcCgpB'
    'c3NpZ25tZW50EhQKBWVwb2NoGAEgASgEUgVlcG9jaBI4CgZzaGFyZHMYAiADKAsyIC5nb2ZyLmNsdXN0ZXIudjEu'
    'U2hhcmRBc3NpZ25tZW50UgZzaGFyZHMilAEKD1NoYXJkQXNzaWdubWVudBIXCgdob3N0X2lkGAEgASgJUgZob3N0'
    'SWQSGAoHYWRkcmVzcxgCIAEoCVIHYWRkcmVzcxIfCgtzaGFyZF9pbmRleBgDIAEoBVIKc2hhcmRJbmRleBIZCghu'
    'X3NoYXJkcxgEIAEoBVIHblNoYXJkcxISCgRyb2xlGAUgASgJUgRyb2xlIhAKDk1lbWJlcnNSZXF1ZXN0InIKD01l'
    'bWJlcnNSZXNwb25zZRIWCgZzdGF0dXMYASABKAlSBnN0YXR1cxIUCgVlcG9jaBgCIAEoBFIFZXBvY2gSMQoHbWVt'
    'YmVycxgDIAMoCzIXLmdvZnIuY2x1c3Rlci52MS5NZW1iZXJSB21lbWJlcnMixAEKBk1lbWJlchIXCgdob3N0X2lk'
    'GAEgASgJUgZob3N0SWQSGAoHYWRkcmVzcxgCIAEoCVIHYWRkcmVzcxIUCgVzdGF0ZRgDIAEoCVIFc3RhdGUSLwoU'
    'bGFzdF9oZWFydGJlYXRfYWdlX3MYBCABKAJSEWxhc3RIZWFydGJlYXRBZ2VTEh8KC3NoYXJkX2luZGV4GAUgASgF'
    'UgpzaGFyZEluZGV4Eh8KC2hlYWx0aF9qc29uGAYgASgJUgpoZWFsdGhKc29uMoECCgxDb29yZGluYXRpb24STwoI'
    'UmVnaXN0ZXISIC5nb2ZyLmNsdXN0ZXIudjEuUmVnaXN0ZXJSZXF1ZXN0GiEuZ29mci5jbHVzdGVyLnYxLlJlZ2lz'
    'dGVyUmVzcG9uc2USUgoJSGVhcnRiZWF0EiEuZ29mci5jbHVzdGVyLnYxLkhlYXJ0YmVhdFJlcXVlc3QaIi5nb2Zy'
    'LmNsdXN0ZXIudjEuSGVhcnRiZWF0UmVzcG9uc2USTAoHTWVtYmVycxIfLmdvZnIuY2x1c3Rlci52MS5NZW1iZXJz'
    'UmVxdWVzdBogLmdvZnIuY2x1c3Rlci52MS5NZW1iZXJzUmVzcG9uc2ViBnByb3RvMw=='
)
MESSAGES = load_messages(_FDS)

RegisterRequest = MESSAGES['gofr.cluster.v1.RegisterRequest']
LabelsEntry = MESSAGES['gofr.cluster.v1.RegisterRequest.LabelsEntry']
RegisterResponse = MESSAGES['gofr.cluster.v1.RegisterResponse']
HeartbeatRequest = MESSAGES['gofr.cluster.v1.HeartbeatRequest']
HeartbeatResponse = MESSAGES['gofr.cluster.v1.HeartbeatResponse']
Assignment = MESSAGES['gofr.cluster.v1.Assignment']
ShardAssignment = MESSAGES['gofr.cluster.v1.ShardAssignment']
MembersRequest = MESSAGES['gofr.cluster.v1.MembersRequest']
MembersResponse = MESSAGES['gofr.cluster.v1.MembersResponse']
Member = MESSAGES['gofr.cluster.v1.Member']

class CoordinationGofrServicer(GofrGrpcService):
    """Subclass and implement each RPC with the Context-first
    signature; register via app.register_grpc_service()."""

    SERVICE_NAME = 'gofr.cluster.v1.Coordination'
    FILE_DESCRIPTOR_SET = _FDS
    MESSAGES = MESSAGES
    METHODS = {
        'Register': ('unary_unary', 'gofr.cluster.v1.RegisterRequest', 'gofr.cluster.v1.RegisterResponse'),
        'Heartbeat': ('unary_unary', 'gofr.cluster.v1.HeartbeatRequest', 'gofr.cluster.v1.HeartbeatResponse'),
        'Members': ('unary_unary', 'gofr.cluster.v1.MembersRequest', 'gofr.cluster.v1.MembersResponse'),
    }

    async def Register(self, ctx: Any, request: RegisterRequest) -> RegisterResponse:
        raise NotImplementedError('Register')

    async def Heartbeat(self, ctx: Any, request: HeartbeatRequest) -> HeartbeatResponse:
        raise NotImplementedError('Heartbeat')

    async def Members(self, ctx: Any, request: MembersRequest) -> MembersResponse:
        raise NotImplementedError('Members')

class CoordinationGofrClient:
    """Typed client for gofr.cluster.v1.Coordination over the port's channel."""

    def __init__(self, target: str) -> None:
        self._channel = Channel(target)
        self._Register = self._channel.unary_unary(
            '/gofr.cluster.v1.Coordination/Register',
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=RegisterResponse.FromString,
        )
        self._Heartbeat = self._channel.unary_unary(
            '/gofr.cluster.v1.Coordination/Heartbeat',
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=HeartbeatResponse.FromString,
        )
        self._Members = self._channel.unary_unary(
            '/gofr.cluster.v1.Coordination/Members',
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=MembersResponse.FromString,
        )

    async def Register(self, request: RegisterRequest, **kw: Any) -> RegisterResponse:
        return await self._Register(request, **kw)

    async def Heartbeat(self, request: HeartbeatRequest, **kw: Any) -> HeartbeatResponse:
        return await self._Heartbeat(request, **kw)

    async def Members(self, request: MembersRequest, **kw: Any) -> MembersResponse:
        return await self._Members(request, **kw)

    async def close(self) -> None:
        await self._channel.close()

