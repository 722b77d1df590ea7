# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: exproto.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rexproto.proto\x12\x0f\x65mqx.exproto.v1\"\x0e\n\x0c\x45mptySuccess\"J\n\x0c\x43odeResponse\x12)\n\x04\x63ode\x18\x01 \x01(\x0e\x32\x1b.emqx.exproto.v1.ResultCode\x12\x0f\n\x07message\x18\x02 \x01(\t\"/\n\x10SendBytesRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12\r\n\x05\x62ytes\x18\x02 \x01(\x0c\"\"\n\x12\x43loseSocketRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\"~\n\nClientInfo\x12\x12\n\nproto_name\x18\x01 \x01(\t\x12\x11\n\tproto_ver\x18\x02 \x01(\t\x12\x10\n\x08\x63lientid\x18\x03 \x01(\t\x12\x10\n\x08username\x18\x04 \x01(\t\x12\x12\n\nmountpoint\x18\x05 \x01(\t\x12\x11\n\tkeepalive\x18\x06 \x01(\r\"f\n\x13\x41uthenticateRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12/\n\nclientinfo\x18\x02 \x01(\x0b\x32\x1b.emqx.exproto.v1.ClientInfo\x12\x10\n\x08password\x18\x03 \x01(\t\"X\n\x0cTimerRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12(\n\x04type\x18\x02 \x01(\x0e\x32\x1a.emqx.exproto.v1.TimerType\x12\x10\n\x08interval\x18\x03 \x01(\r\"K\n\x0ePublishRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x0b\n\x03qos\x18\x03 \x01(\r\x12\x0f\n\x07payload\x18\x04 \x01(\x0c\"<\n\x10SubscribeRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x0b\n\x03qos\x18\x03 \x01(\r\"1\n\x12UnsubscribeRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\"%\n\x07\x41\x64\x64ress\x12\x0c\n\x04host\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\"\x91\x01\n\x08\x43onnInfo\x12-\n\x08socktype\x18\x01 \x01(\x0e\x32\x1b.emqx.exproto.v1.SocketType\x12*\n\x08peername\x18\x02 \x01(\x0b\x32\x18.emqx.exproto.v1.Address\x12*\n\x08sockname\x18\x03 \x01(\x0b\x32\x18.emqx.exproto.v1.Address\"Q\n\x14SocketCreatedRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12+\n\x08\x63onninfo\x18\x02 \x01(\x0b\x32\x19.emqx.exproto.v1.ConnInfo\"3\n\x13SocketClosedRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12\x0e\n\x06reason\x18\x02 \x01(\t\"3\n\x14ReceivedBytesRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12\r\n\x05\x62ytes\x18\x02 \x01(\x0c\"M\n\x13TimerTimeoutRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12(\n\x04type\x18\x02 \x01(\x0e\x32\x1a.emqx.exproto.v1.TimerType\"q\n\x07Message\x12\x0c\n\x04node\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\x12\x0b\n\x03qos\x18\x03 \x01(\r\x12\x0c\n\x04\x66rom\x18\x04 \x01(\t\x12\r\n\x05topic\x18\x05 \x01(\t\x12\x0f\n\x07payload\x18\x06 \x01(\x0c\x12\x11\n\ttimestamp\x18\x07 \x01(\x04\"S\n\x17ReceivedMessagesRequest\x12\x0c\n\x04\x63onn\x18\x01 \x01(\t\x12*\n\x08messages\x18\x02 \x03(\x0b\x32\x18.emqx.exproto.v1.Message*\x8a\x01\n\nResultCode\x12\x0b\n\x07SUCCESS\x10\x00\x12\x0b\n\x07UNKNOWN\x10\x01\x12\x1a\n\x16\x43ONN_PROCESS_NOT_ALIVE\x10\x02\x12\x1a\n\x16REQUIRED_PARAMS_MISSED\x10\x03\x12\x15\n\x11PARAMS_TYPE_ERROR\x10\x04\x12\x13\n\x0fPERMISSION_DENY\x10\x05*1\n\nSocketType\x12\x07\n\x03TCP\x10\x00\x12\x07\n\x03SSL\x10\x01\x12\x07\n\x03UDP\x10\x02\x12\x08\n\x04\x44TLS\x10\x03*\x1a\n\tTimerType\x12\r\n\tKEEPALIVE\x10\x00\x32\xc6\x04\n\x11\x43onnectionAdapter\x12J\n\x04Send\x12!.emqx.exproto.v1.SendBytesRequest\x1a\x1d.emqx.exproto.v1.CodeResponse\"\x00\x12M\n\x05\x43lose\x12#.emqx.exproto.v1.CloseSocketRequest\x1a\x1d.emqx.exproto.v1.CodeResponse\"\x00\x12U\n\x0c\x41uthenticate\x12$.emqx.exproto.v1.AuthenticateRequest\x1a\x1d.emqx.exproto.v1.CodeResponse\"\x00\x12L\n\nStartTimer\x12\x1d.emqx.exproto.v1.TimerRequest\x1a\x1d.emqx.exproto.v1.CodeResponse\"\x00\x12K\n\x07Publish\x12\x1f.emqx.exproto.v1.PublishRequest\x1a\x1d.emqx.exproto.v1.CodeResponse\"\x00\x12O\n\tSubscribe\x12!.emqx.exproto.v1.SubscribeRequest\x1a\x1d.emqx.exproto.v1.CodeResponse\"\x00\x12S\n\x0bUnsubscribe\x12#.emqx.exproto.v1.UnsubscribeRequest\x1a\x1d.emqx.exproto.v1.CodeResponse\"\x00\x32\xe6\x03\n\x11\x43onnectionHandler\x12[\n\x0fOnSocketCreated\x12%.emqx.exproto.v1.SocketCreatedRequest\x1a\x1d.emqx.exproto.v1.EmptySuccess\"\x00(\x01\x12Y\n\x0eOnSocketClosed\x12$.emqx.exproto.v1.SocketClosedRequest\x1a\x1d.emqx.exproto.v1.EmptySuccess\"\x00(\x01\x12[\n\x0fOnReceivedBytes\x12%.emqx.exproto.v1.ReceivedBytesRequest\x1a\x1d.emqx.exproto.v1.EmptySuccess\"\x00(\x01\x12Y\n\x0eOnTimerTimeout\x12$.emqx.exproto.v1.TimerTimeoutRequest\x1a\x1d.emqx.exproto.v1.EmptySuccess\"\x00(\x01\x12\x61\n\x12OnReceivedMessages\x12(.emqx.exproto.v1.ReceivedMessagesRequest\x1a\x1d.emqx.exproto.v1.EmptySuccess\"\x00(\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'exproto_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RESULTCODE._serialized_start=1379
  _RESULTCODE._serialized_end=1517
  _SOCKETTYPE._serialized_start=1519
  _SOCKETTYPE._serialized_end=1568
  _TIMERTYPE._serialized_start=1570
  _TIMERTYPE._serialized_end=1596
  _EMPTYSUCCESS._serialized_start=34
  _EMPTYSUCCESS._serialized_end=48
  _CODERESPONSE._serialized_start=50
  _CODERESPONSE._serialized_end=124
  _SENDBYTESREQUEST._serialized_start=126
  _SENDBYTESREQUEST._serialized_end=173
  _CLOSESOCKETREQUEST._serialized_start=175
  _CLOSESOCKETREQUEST._serialized_end=209
  _CLIENTINFO._serialized_start=211
  _CLIENTINFO._serialized_end=337
  _AUTHENTICATEREQUEST._serialized_start=339
  _AUTHENTICATEREQUEST._serialized_end=441
  _TIMERREQUEST._serialized_start=443
  _TIMERREQUEST._serialized_end=531
  _PUBLISHREQUEST._serialized_start=533
  _PUBLISHREQUEST._serialized_end=608
  _SUBSCRIBEREQUEST._serialized_start=610
  _SUBSCRIBEREQUEST._serialized_end=670
  _UNSUBSCRIBEREQUEST._serialized_start=672
  _UNSUBSCRIBEREQUEST._serialized_end=721
  _ADDRESS._serialized_start=723
  _ADDRESS._serialized_end=760
  _CONNINFO._serialized_start=763
  _CONNINFO._serialized_end=908
  _SOCKETCREATEDREQUEST._serialized_start=910
  _SOCKETCREATEDREQUEST._serialized_end=991
  _SOCKETCLOSEDREQUEST._serialized_start=993
  _SOCKETCLOSEDREQUEST._serialized_end=1044
  _RECEIVEDBYTESREQUEST._serialized_start=1046
  _RECEIVEDBYTESREQUEST._serialized_end=1097
  _TIMERTIMEOUTREQUEST._serialized_start=1099
  _TIMERTIMEOUTREQUEST._serialized_end=1176
  _MESSAGE._serialized_start=1178
  _MESSAGE._serialized_end=1291
  _RECEIVEDMESSAGESREQUEST._serialized_start=1293
  _RECEIVEDMESSAGESREQUEST._serialized_end=1376
  _CONNECTIONADAPTER._serialized_start=1599
  _CONNECTIONADAPTER._serialized_end=2181
  _CONNECTIONHANDLER._serialized_start=2184
  _CONNECTIONHANDLER._serialized_end=2670
# @@protoc_insertion_point(module_scope)
